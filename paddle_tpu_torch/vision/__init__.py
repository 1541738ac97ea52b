"""The vision package of the port. Counterpart of ``paddle_tpu/vision``:
``models`` (ResNet, VGG, MobileNetV1/V2, LeNet), ``transforms``,
``datasets``, ``ops`` (IoU, box coding, priors and anchors, YOLO decoding,
NMS, RoI align) and ``detection_train`` (matching, target assignment, the
SSD, YOLOv3 and focal losses, proposals, FPN routing, the RoI pools and
the deformable ops), re-exported as the reference does."""
from . import datasets, detection_train, models, ops, transforms
from .datasets import *  # noqa: F401,F403
from .detection_train import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .transforms import *  # noqa: F401,F403
