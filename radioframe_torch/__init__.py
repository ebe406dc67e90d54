"""radioframe_torch — the PyTorch + CUDA (Hopper) port of the radioframe
receive chain.

The JAX package ``radioframe`` stays beside this one as the reference each
module is held against (``tests/test_torch_*.py``). This package imports
``torch`` and never ``jax``; from the reference it reuses only the host
modules that import nothing but numpy and scipy (``core/config.py``,
``ops/filter_design.py``, ``io/fixtures.py``, ``diag/metrics.py``,
``golden/model.py``).
"""

from radioframe_torch.device import pin_precision

pin_precision()
