"""Model zoo of the port (``bigdl_tpu/models``): BERT so far."""
