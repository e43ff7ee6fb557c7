"""Model zoo of the port (``bigdl_tpu/models``): autoencoder, BERT,
Inception-v1, LeNet-5, Mask R-CNN, ResNet, the RNN language model and
VGG. Each builder takes ``device=`` (``None``: the GPU)."""
