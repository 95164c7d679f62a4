"""The data path on the card: staging, the device prologue, moving host
batches, and worker processes beside a process that holds CUDA.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_io_gpu.py

- ``DevicePrefetchIter`` stages host batches from pinned memory on a side
  stream: over 50 batches the staged tensors equal the host batches bit
  for bit, with each host batch overwritten straight after the ``next()``
  that staged it, or with a source that refills one pinned buffer at every
  ``next()``, and the consumer reading the staged tensor at once on its
  own stream (no wait on the copies' event would show here).
- ``DeviceAugmenter`` on the card equals its CPU path; a numpy batch lands
  on the card unless the caller asks for the CPU.
- ``split_and_load`` and ``as_in_context`` from pinned memory give the
  values, on the card.
- ``ImageRecordIter`` forks decode workers from this process after CUDA is
  initialised and still gives the thread path's batches.
- A ``DataLoader`` with spawned workers never initialises CUDA in a child.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.image import DeviceAugmenter
from mxnet_tpu_torch.io.io import host_array

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU: torch sees no CUDA "
                              "device"),
]


class _Batches(mx.io.DataIter):
    """``n`` seeded host batches (pinned), each a fresh buffer kept in
    ``made`` so that the test can overwrite it after it was staged, or
    with ``reuse`` one buffer refilled at every ``next()``."""

    def __init__(self, n, shape=(32, 3, 224, 224), reuse=False):
        super().__init__(shape[0])
        self.n, self.shape, self.i = n, shape, 0
        self.made = {}
        self.reuse, self.buf = reuse, None

    def reset(self):
        self.i = 0

    def next(self):
        if self.i == self.n:
            raise StopIteration
        if self.reuse and self.buf is not None:
            data = self.buf
            data._data.copy_(_expected(self.i, self.shape))
        else:
            data = self.buf = host_array(_expected(self.i, self.shape))
        label = host_array(torch.arange(self.shape[0],
                                        dtype=torch.float32) + self.i)
        self.made[self.i] = data
        self.i += 1
        return mx.io.DataBatch([data], [label])


def _expected(i, shape=(32, 3, 224, 224)):
    g = torch.Generator().manual_seed(i)
    return torch.rand(shape, generator=g)


@pytest.mark.parametrize("shape,reuse", [((32, 3, 224, 224), False),
                                         ((8, 3, 64, 64), False),
                                         ((32, 3, 224, 224), True)])
def test_staging_on_a_side_stream_equals_host_batches(shape, reuse):
    src = _Batches(50, shape, reuse)
    assert src.next().data[0]._data.is_pinned()
    it = mx.io.DevicePrefetchIter(src, depth=2, ctx=mx.gpu(0))
    n = 0
    for i, b in enumerate(it):
        # the host batch of this step is overwritten at once (with reuse,
        # by the source's own refills), and the staged one read at once on
        # the consumer's stream
        made = src.made.pop(i)
        if not reuse:
            made._data.fill_(-1.0)
        x, y = b.data[0]._data, b.label[0]._data
        assert x.is_cuda and y.is_cuda
        total = x.double().sum()
        want = _expected(i, shape)
        assert torch.equal(x.cpu(), want), f"staged batch {i} differs"
        assert total.item() == want.double().sum().item()
        assert torch.equal(y.cpu(), torch.arange(
            shape[0], dtype=torch.float32) + i)
        n += 1
    assert n == 50


@pytest.mark.parametrize("rand_crop", [True, False])
def test_device_augmenter_on_the_card_equals_its_cpu_path(rand_crop):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (32, 3, 256, 256)).astype("uint8")
    flips = rng.rand(32) < 0.5
    crops = rng.rand(32, 2)
    aug = DeviceAugmenter((224, 224), mean=(123.68, 116.779, 103.939),
                          std=(58.393, 57.12, 57.375), rand_crop=rand_crop,
                          rand_mirror=True)
    card = aug(mx.nd.array(x, ctx=mx.gpu(0), dtype="uint8"), flips, crops)
    cpu = aug(mx.nd.array(x, ctx=mx.cpu(), dtype="uint8"), flips, crops)
    # a numpy batch goes to the current context: the card by default
    default = aug(x, flips, crops)
    assert card.context == mx.gpu(0) and default.is_cuda
    np.testing.assert_allclose(card.asnumpy(), cpu.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(default, card._data)
    with mx.cpu():
        assert aug(x, flips, crops).device.type == "cpu"
    assert aug.compile_misses == 1


def test_split_and_load_from_pinned_memory():
    x = host_array(np.arange(64 * 10, dtype="float32").reshape(64, 10))
    assert x._data.is_pinned() and x.context == mx.cpu()
    parts = mx.gluon.utils.split_and_load(x, [mx.gpu(0), mx.gpu(0)])
    assert all(p.context == mx.gpu(0) for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p.asnumpy() for p in parts]), x.asnumpy())
    one = x.as_in_context(mx.gpu(0))
    assert one.context == mx.gpu(0)
    np.testing.assert_array_equal(one.asnumpy(), x.asnumpy())
    np.testing.assert_array_equal(
        mx.gluon.utils.split_and_load(
            host_array(np.ones((4, 2), "float32")), [mx.gpu(0)])[0]
        .asnumpy(), np.ones((4, 2)))


def _rec(tmp_path, n=24, hw=(40, 48)):
    path = str(tmp_path / "g.rec")
    w = recordio.MXRecordIO(path, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = (rng.rand(*hw, 3) * 255).astype("uint8")
        w.write(recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                  img, quality=85))
    w.close()
    return path


def test_forked_decode_workers_after_cuda_init(tmp_path):
    torch.cuda.init()
    torch.ones(1, device="cuda").sum().item()
    path = _rec(tmp_path)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
              seed=3)
    a = mx.io.ImageRecordIter(**kw)
    b = mx.io.ImageRecordIter(preprocess_processes=2, pipeline_timeout=60,
                              **kw)
    try:
        n = 0
        for x, y in zip(a, b):
            assert torch.equal(x.data[0]._data, y.data[0]._data)
            assert x.data[0]._data.is_pinned()
            n += 1
        assert n == 3
    finally:
        a.close()
        b.close()


def _cuda_state(_):
    """(CUDA initialised in this worker, GPUs visible to it)."""
    return (float(torch.cuda.is_initialized()),
            float(torch.cuda.device_count()))


def test_dataloader_workers_never_initialise_cuda():
    torch.ones(1, device="cuda").sum().item()
    assert torch.cuda.is_initialized()
    ds = mx.gluon.data.SimpleDataset(list(range(8))).transform(_cuda_state)
    loader = mx.gluon.data.DataLoader(ds, batch_size=4, num_workers=2,
                                      timeout=120)
    seen = [b for b in loader]
    flat = np.concatenate([np.stack([s.asnumpy() for s in b], 1)
                           for b in seen])
    assert flat.shape == (8, 2)
    assert (flat == 0).all(), flat
    assert os.environ.get("CUDA_VISIBLE_DEVICES") != ""
