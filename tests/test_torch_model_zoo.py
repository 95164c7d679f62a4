"""The port's vision model zoo against the JAX package's, on the CPU.

Every ``get_model`` name of the JAX package (34) builds in the port with
the same ``collect_params()`` names in the same order, so that a JAX
``save_parameters`` file loads by name.  AlexNet, VGG-11 (with and
without BatchNorm), SqueezeNet 1.0 and 1.1 and a small DenseNet carry
seeded weights from the JAX net to the port only through a ``.params``
file; their inference logits at batch 1 must agree within 1e-4 of the
largest logit (fp32 both sides, the two backends summing in different
orders).  The sizes are the smallest each net takes (AlexNet 64x64, VGG
32x32; SqueezeNet's 13x13 pool and DenseNet's 7x7 one want 224x224), so
that the JAX package's first forward, which compiles each op, stays
cheap.  ``tests/test_torch_model_zoo_bn.py`` holds the BatchNorm
families.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.block import is_deferred
from mxnet_tpu_torch.gluon.model_zoo import get_model, vision

JAX_NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
             "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
             "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16",
             "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
             "alexnet", "densenet121", "densenet161", "densenet169",
             "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
             "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
             "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
             "mobilenetv2_0.5", "mobilenetv2_0.25"]


def seeded(name, shape, rng):
    """Non-trivial values by parameter name: BN statistics with variance
    > 0, He-scaled weights, gammas under one (logits stay O(1))."""
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("running_mean", "beta", "bias")):
        return rng.normal(0, 0.1, shape)
    if name.endswith("gamma"):
        return rng.uniform(0.2, 0.6, shape)
    fan_in = int(np.prod(shape[1:]))
    return rng.normal(0, np.sqrt(2.0 / fan_in), shape)


def seeded_jax_net(make, x, seed=0):
    """A JAX net from ``make()`` (built in a fresh name scope), its
    deferred shapes fixed by a forward on ``x`` and its parameters
    seeded."""
    with jmx.name.NameManager():
        net = make()
    net.initialize()
    net(jmx.nd.array(x))
    rng = np.random.RandomState(seed)
    for pname, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(jmx.nd.array(seeded(pname, p.shape, rng)
                                .astype("float32")))
    return net


def hold_logits(jnet, port, x, path):
    """The JAX net's inference logits on ``x`` against the port's, the
    weights carried through the ``.params`` file at ``path``."""
    ref = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(path))
    return hold_logits_to(ref, port, x, path)


def hold_logits_to(ref, port, x, path):
    """The port's inference logits on ``x``, its weights loaded from the
    JAX net's ``.params`` file at ``path``, against that net's ``ref``."""
    assert any(is_deferred(t) for t in
               port._collect_params_with_prefix().values())
    port.load_parameters(str(path))
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = np.abs(ref).max()
    assert scale > 1e-3
    err = np.abs(out - ref).max()
    assert err <= 1e-4 * scale, f"{err:.3g} > 1e-4 * {scale:.3g}"
    return out


def test_every_jax_name_builds_with_the_jax_parameter_names():
    """``collect_params()`` keys, prefixes and order equal the JAX net's
    for all 34 names (no forward: the deferred shapes stay unknown);
    every name is in the port's ``get_model``, and no other."""
    assert sorted(vision._MODELS) == sorted(JAX_NAMES)
    for name in JAX_NAMES:
        with jmx.name.NameManager():
            want = list(jvision.get_model(name, classes=10)
                        .collect_params().keys())
        with mx.name.NameManager(), mx.cpu():
            got = list(get_model(name, classes=10).collect_params().keys())
        assert got == want, name
    with pytest.raises(ValueError, match="not supported"):
        get_model("inception_v3", device="cpu")


@pytest.mark.parametrize("name, hw", [("alexnet", 64), ("vgg11", 32),
                                      ("vgg11_bn", 32),
                                      ("squeezenet1.0", 224),
                                      ("squeezenet1.1", 224)])
def test_logits_match_jax_through_params_file(name, hw, tmp_path):
    x = np.random.RandomState(4).randn(1, 3, hw, hw).astype("float32")
    jnet = seeded_jax_net(lambda: jvision.get_model(name, classes=10), x)
    with mx.name.NameManager():
        port = get_model(name, classes=10, device="cpu")
    hold_logits(jnet, port, x, tmp_path / "w.params")
    assert list(port.collect_params().keys()) == \
        list(jnet.collect_params().keys())


def test_small_densenet_logits_match_jax(tmp_path):
    """``DenseNet(16, 8, [2, 2, 2, 2], classes=10)``: the same blocks as
    DenseNet-121 (dense layers concatenating 8 channels each, three
    halving transitions, the 7x7 pool at 224x224) at a width and depth
    the JAX package compiles quickly."""
    x = np.random.RandomState(5).randn(1, 3, 224, 224).astype("float32")
    jnet = seeded_jax_net(
        lambda: jvision.DenseNet(16, 8, [2, 2, 2, 2], classes=10), x)
    with mx.name.NameManager():
        port = vision.DenseNet(16, 8, [2, 2, 2, 2], classes=10,
                               device="cpu")
    hold_logits(jnet, port, x, tmp_path / "d.params")
    # 1 + 2 x 2 a block + 3 transitions + 1
    bns = [m for m in port.modules()
           if isinstance(m, mx.gluon.nn.BatchNorm)]
    assert len(bns) == 21
