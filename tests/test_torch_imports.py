"""The port stands alone: mxnet_tpu_torch and chip_smoke.py import neither
JAX, the JAX package nor ``ml_dtypes`` (which the card's machine lacks), and
the port's entry points never land on the CPU unless asked to."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import context, rtc
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.models import get_bert_model, ssd
from mxnet_tpu_torch.serving import ModelRuntime

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "flash_bench.py",
              ROOT / "rowdot_bench.py", ROOT / "paged_attention_bench.py",
              ROOT / "zoo_parity_probe.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{line} imports {name}"
           for f in files for name, line in _imported_roots(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'mxnet_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import mxnet_tpu_torch\n"
            "import mxnet_tpu_torch.ops.flash_attention, "
            "mxnet_tpu_torch.models.bert, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.rtc, mxnet_tpu_torch.gluon.model_zoo, "
            "mxnet_tpu_torch.ops.bn_stats, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.parameter, "
            "mxnet_tpu_torch.ops.optimizer_ops, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.test_utils, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.model, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.contrib.amp, "
            "mxnet_tpu_torch.contrib.amp.loss_scaler, "
            "mxnet_tpu_torch.contrib.amp.lists, "
            "mxnet_tpu_torch.ops.contrib_ops, mxnet_tpu_torch.ops.nms, "
            "mxnet_tpu_torch.models.ssd, mxnet_tpu_torch.image.detection\n"
            "from mxnet_tpu_torch.io import ImageDetRecordIter\n"
            "s = mxnet_tpu_torch.sym.FullyConnected("
            "mxnet_tpu_torch.sym.var('data'), num_hidden=2)\n"
            "s.simple_bind(ctx=mxnet_tpu_torch.cpu(), data=(1, 3)).forward()\n"
            "mxnet_tpu_torch.nd.array([1.0], ctx=mxnet_tpu_torch.cpu())\n"
            "assert not any(k.split('.')[0] in ('jax', 'mxnet_tpu', "
            "'ml_dtypes') and "
            "sys.modules[k] is not None for k in sys.modules)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_bert_model("bert_tiny", vocab_size=10, max_length=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.default_device()
    net = get_bert_model("bert_tiny", vocab_size=10, max_length=8,
                         device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRuntime(net, ((8,), (8,)), dtype="int32", max_batch=1)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("resnet50_v1")
    resnet = get_model("resnet50_v1", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRuntime(resnet, (3, 224, 224), max_batch=8, warm=False)
    ModelRuntime(resnet, (3, 224, 224), max_batch=8, warm=False,
                 device="cpu")

    # SSD and its operators: the model, and detection on arrays made on
    # the current context
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd.ssd_300_vgg16()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd.VGG16Base()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.contrib.MultiBoxPrior(mx.nd.zeros((1, 3, 4, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.contrib.box_nms(mx.nd.array([[0, 0.9, 0, 0, 1, 1]]))

    # mx.rtc names what it lacks: the toolkit's NVRTC or the driver where
    # they are absent, else the device
    missing = r"NVRTC \(libnvrtc.so\)|libcuda.so.1|needs a CUDA device"
    with pytest.raises(RuntimeError, match=missing):
        rtc.CudaModule('extern "C" __global__ void k() {}')
    with pytest.raises(RuntimeError, match=missing):
        rtc.compile_cuda("", "double_k", ((8, 128), "float32"))

    # mx.nd makes arrays on the current context: the GPU unless a scope or
    # ctx= says otherwise
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.array([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.zeros((2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.random.uniform(shape=(2,))
    assert mx.nd.zeros((2,), ctx=mx.cpu()).context == mx.cpu()

    # the symbolic path too: Module, simple_bind and the kvstore
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.mod.Module(net, label_names=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.simple_bind(data=(1, 3))
    with mx.cpu():
        assert net.simple_bind(data=(1, 3)).arg_dict["data"].context == \
            mx.cpu()


def test_contexts_name_torch_devices():
    assert context.gpu(1).torch_device() == torch.device("cuda", 1)
    assert context.cpu().torch_device() == torch.device("cpu")
    assert context.as_device(context.cpu()) == torch.device("cpu")
    assert context.as_device("cpu") == torch.device("cpu")
    assert context.gpu(0) == context.gpu(0) != context.cpu(0)


def test_detection_batches_are_host_batches_moved_to_the_card(
        monkeypatch, tmp_path):
    """``ImageDetRecordIter`` gives host batches (CPU NDArrays, as MXNet's
    iterators do); moving one to the current context, as a training loop
    does, raises for want of a device."""
    import numpy as np
    from mxnet_tpu_torch import recordio
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = str(tmp_path / "det.rec")
    w = recordio.MXRecordIO(rec, "w")
    label = np.array([2, 5, 1, 0.1, 0.2, 0.5, 0.6], "float32")
    w.write(recordio.pack_img(recordio.IRHeader(0, label, 0, 0),
                              np.zeros((8, 8, 3), np.uint8), img_fmt=".png"))
    w.close()
    batch = next(iter(mx.io.ImageDetRecordIter(
        path_imgrec=rec, data_shape=(3, 8, 8), batch_size=1,
        label_pad_width=12)))
    assert batch.data[0].context == batch.label[0].context == mx.cpu()
    assert batch.label[0].shape == (1, 2, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.data[0].as_in_context(mx.current_context())
