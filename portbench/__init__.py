"""The benchmark of the PyTorch and CUDA port (``yolo_quantization_tpu_torch``)
on one H100: see ``README.md``."""
