"""ggml block quantization formats (the port of ``bigdl_tpu.llm.ggml``)."""
