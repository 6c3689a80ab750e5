"""avenir_tpu_torch — the PyTorch/CUDA port of ``avenir_tpu``.

The JAX package stays the reference; this package keeps its module layout
and names (``utils``, ``ops``, ``models``, ``parallel``, ``cli``) and its
CLI verbs, keys, schemas and file formats. It imports ``torch``, never
``jax``, and nothing of ``avenir_tpu``. Its kernels are CUDA C++ for
Hopper (``csrc/``), built with nvcc at first use. Entry points run on
CUDA unless the caller passes ``device="cpu"`` (``--device cpu``).
"""

from avenir_tpu_torch import cli  # noqa: F401
