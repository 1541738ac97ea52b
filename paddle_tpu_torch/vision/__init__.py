"""The vision package of the port. Counterpart of ``paddle_tpu/vision``:
``models`` (ResNet, VGG, MobileNetV1/V2, LeNet), ``transforms`` and
``datasets``. ``vision/ops.py`` and ``vision/detection_train.py`` (NMS,
RoI pooling and alignment, deformable convolution, the detection losses
and target assigners) are not ported yet (ROADMAP.md, Queue 1 item 6b)."""
from . import datasets, models, transforms
from .datasets import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .transforms import *  # noqa: F401,F403
