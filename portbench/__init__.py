"""The PyTorch and CUDA port's benchmark (``python portbench/run.py``)."""
