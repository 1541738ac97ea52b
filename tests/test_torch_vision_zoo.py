"""The port's other vision models against the JAX package's, on the CPU.

- The models of ``vision.models``: the same state-dict keys and shapes
  as the reference's (``fc`` weights transposed), a round trip through
  ``interop`` (ResNet-18/50 in ``test_torch_vision_models.py`` and
  ``test_torch_vision_resnet50.py``; LeNet, MobileNetV2 and VGG11 with
  their forwards in ``test_torch_vision_forwards.py``).

``LeNet`` through ``hapi.Model.fit`` is in ``test_torch_vision_buffers.py``.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.vision as jvision

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)


MODELS = [('resnet34', {}), ('mobilenet_v1', {'scale': 0.25}),
          ('LeNet', {})]


@pytest.mark.parametrize('name,kw', MODELS)
def test_every_model_moves_through_interop(name, kw):
    paddle.seed(13)
    ref = getattr(jvision.models, name)(num_classes=10, **kw)
    port = getattr(tvision.models, name)(num_classes=10, device='cpu', **kw)
    want = {k: v.shape for k, v in ref.state_dict().items()}
    own = to_paddle_tpu_state(port)
    assert {k: v.shape for k, v in own.items()} == \
        {k: tuple(s) for k, s in want.items()}
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_paddle_tpu_state(port, state)
    back = to_paddle_tpu_state(port)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
