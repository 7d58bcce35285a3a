"""GAN training algorithms as pure, jit-compiled train steps.

Registered names (parity with ``gan/algorithms/registry.py``): ``gan``
(NSGAN, ``gan/algorithms/gan.py``) and ``wgan-gp``
(``gan/algorithms/wgan_gp.py``). The reference's stale ``lswgan`` import
(SURVEY.md §2.11.1) is not reproduced.
"""

from calciumgan.algorithms import gan, wgan_gp  # noqa: F401
from calciumgan.algorithms.registry import algorithms, get_algorithm  # noqa: F401
from calciumgan.algorithms.state import GANState, NetState  # noqa: F401
