"""Training plane: datasets -> QAT -> deployable int8 artifacts.

Counterpart of ``flowsentryx_tpu/train/`` on PyTorch (the card by
default, the CPU with ``device="cpu"``):

* :mod:`.data` — CICIDS2017/CICDDoS2019 CSV loading and cleaning
  (standard-library ``csv``, no pandas), the synthetic labelled set and
  the seeded split;
* :mod:`.fixture` — the CICIDS-calibrated fixture (numpy, byte-equal to
  the reference's);
* :mod:`.qat` — quantization-aware training of the int8 logistic
  regression and the MLP / multiclass trainers;
* :mod:`.optim` — optax's Adagrad and Adam, op for op;
* :mod:`.evaluate` — accuracy / precision / recall / F1 / confusion;
* :mod:`.stress` — off-assumption generalization stress.
"""

from flowsentryx_tpu_torch.train import data as data  # noqa: F401
from flowsentryx_tpu_torch.train import evaluate as evaluate  # noqa: F401
from flowsentryx_tpu_torch.train import qat as qat  # noqa: F401
