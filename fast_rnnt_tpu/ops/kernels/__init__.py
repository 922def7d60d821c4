"""Hand-written accelerator kernels: the GPU wavefront recursion
(``mutual_information.cu``) and the GSPMD wrapper that runs such opaque
calls per batch shard (``partition.py``)."""
