"""Model zoo of the port (``bigdl_tpu/models``): BERT, LeNet-5 and
ResNet so far."""
