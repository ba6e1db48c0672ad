"""The benchmark of the PyTorch/CUDA port (``python3 cardbench/run.py``)."""
