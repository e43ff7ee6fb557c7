"""Model families (the port of ``bigdl_tpu.llm.models``)."""
