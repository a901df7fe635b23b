"""PyTorch/CUDA port of ``pyspark_tf_gke_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here keeps
its counterpart's name so a reader can find it. The port imports
``torch``, ``numpy`` and the standard library only — never JAX and never
the JAX package. Entry points run on ``device="cuda"`` unless the caller
asks for the CPU (the tests do); a CUDA tensor either launches a
hand-written kernel (``csrc/``) or raises.
"""
