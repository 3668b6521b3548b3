"""The benchmark of the PyTorch and CUDA port (``gsconverter_tpu_torch``)."""
