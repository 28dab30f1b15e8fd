"""The benchmark of the PyTorch and CUDA port, ``dspi_tpu_torch``.

``run.py`` runs one cell once; ``harness.py`` is the run; ``entries/``,
``metrics/``, ``configs/`` and ``workloads/`` hold what each entry point,
metric, configuration and traffic mix is, one file each, found by name
from ``BENCHMARK.json``; ``reference/`` is the plain reference that
decides ``correct`` with ``compare.py``; ``roofline.py`` and ``trace.py``
are the yardstick's arithmetic.  Nothing here imports JAX or the JAX
package, and the reference imports nothing of the port.
"""
