"""Low-bit LLM inference on PyTorch/CUDA — the port of ``bigdl_tpu.llm``."""
