"""Vision datasets. The port's own copy of ``paddle_tpu/vision/datasets``:
each reads local files when they are there, else makes the reference's
deterministic synthetic set (flagged ``.synthetic``); nothing downloads.
The data home is ``$PADDLE_TPU_DATA_HOME``, else
``~/.cache/paddle_tpu``, as in the reference."""
from .mnist import MNIST, FashionMNIST
from .cifar import Cifar10, Cifar100
from .folder import DatasetFolder, ImageFolder
from .flowers import Flowers
from .voc2012 import VOC2012
