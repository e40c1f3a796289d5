from myriad_tpu_torch.serving.engine import Finished, ServingEngine  # noqa: F401
from myriad_tpu_torch.serving.myriad_adapter import MyriadServing  # noqa: F401
