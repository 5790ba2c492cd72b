"""The benchmark of ``onepose_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``BENCHMARK.json`` at the checkout's root names the
cells, and ``python3 portbench/run.py`` runs one (see ``run.py``). It
imports the port only as the system under test, and nothing of JAX or of
the JAX package."""
