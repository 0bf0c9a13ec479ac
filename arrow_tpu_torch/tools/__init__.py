"""The distributed tools: the counterparts of the JAX package's
``tools/dist_sort_1b.py``, ``tools/scaling_bench.py`` and
``tools/overlap_ab.py`` on ``arrow_tpu_torch.parallel``.

Each runs as ``python -m arrow_tpu_torch.tools.<name>`` (``--help`` lists its
flags), keeps its JAX script's report keys beside the port's own (the
device, the distributed backend, the card's nvidia-smi line) and writes its
report to a ``TORCH_*.json`` file at the root of the checkout.  They import
no jax.
"""
