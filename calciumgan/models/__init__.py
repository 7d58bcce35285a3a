"""Model zoo: WaveGAN-style generators/discriminators in plain JAX.

Registered names (parity with the reference registry —
``gan/models/registry.py``, names at ``calciumgan.py:10``,
``calciumgan2d.py:10``, ``mlp.py:10``): ``calciumgan``, ``calciumgan2d``,
``mlp``. The reference's broken ``__init__`` imports (SURVEY.md §2.11.1) are
not reproduced: importing this package registers exactly the working models.
"""

from calciumgan.models import calciumgan, calciumgan2d, mlp  # noqa: F401
from calciumgan.models.registry import get_models, models  # noqa: F401
