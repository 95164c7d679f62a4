"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``).  The ResNets are
ported; the zoo's other families are not yet (ROADMAP.md, queue 1)."""
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet18_v2, resnet34_v1,  # noqa: F401
                     resnet34_v2, resnet50_v1, resnet50_v2, resnet101_v1,
                     resnet101_v2, resnet152_v1, resnet152_v2)

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A model by name (``device=None`` means the GPU)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"Model {name} is not supported by the port. Available options "
            f"are\n\t" + "\n\t".join(sorted(_MODELS)))
    return _MODELS[name](**kwargs)
