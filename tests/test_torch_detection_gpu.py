"""The greedy NMS kernel (``csrc/nms.cu``) and the detection operators on
the card.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_detection_gpu.py

- the kernel's keep mask against its plain version bit for bit: row
  counts on and around the 64-row tiles (1, 63, 64, 65, 130) and
  SSD-300's 7236 anchors, batch 1-4, with and without class ids,
  thresholds 0.45, 0, -0.1 and 1, invalid rows, rows of equal boxes,
  degenerate and NaN boxes, ``topk``; one launch a call, the plain
  version never given a CUDA tensor;
- ``test_utils.DETECTION_CASES`` on the card against the CPU;
- ``box_nms`` on the card against the same call on the CPU, bit for bit;
  ``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection`` at
  SSD-300's anchors: anchors, masks, class targets, ids, scores and the
  keep pattern bit for bit, the values through ``exp`` and ``log`` (whose
  CUDA and CPU versions round differently) within 4e-7 of the largest.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import contrib_ops as co
from mxnet_tpu_torch.ops import nms
from mxnet_tpu_torch.test_utils import (DETECTION_CASES, case_id, compare,
                                        run_case)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")

    def refuse(boxes, *args, **kwargs):
        assert boxes.device.type == "cpu", "plain NMS given a CUDA tensor"
        return plain(boxes, *args, **kwargs)

    plain = nms._reference
    monkeypatch.setattr(nms, "_reference", refuse)
    return torch.device("cuda")


def _case(rng, b, n, scale=0.3, ids=True):
    boxes = rng.rand(b, n, 4).astype("float32")
    boxes[..., 2:] = boxes[..., :2] + rng.rand(b, n, 2) * scale
    if n > 4:
        boxes[:, 3] = boxes[:, 2]                    # equal boxes
        boxes[:, 4, 2:] = boxes[:, 4, :2]            # a degenerate box
    if n > 6:
        boxes[0, 6, 1] = np.nan
    valid = rng.rand(b, n) > 0.15
    cls = rng.randint(0, 4, (b, n)).astype("float32") if ids else None
    return boxes, valid, cls


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 1), (2, 63), (2, 64), (3, 65),
                                 (4, 130), (2, 7236), (1, 7236)])
@pytest.mark.parametrize("thresh", [0.45, 0.0, -0.1, 1.0])
@pytest.mark.parametrize("ids", [False, True])
def test_kernel_equals_plain(cuda, b, n, thresh, ids):
    rng = np.random.RandomState(n + b)
    boxes, valid, cls = _case(rng, b, n, ids=ids)
    cpu = [torch.from_numpy(a) if a is not None else None
           for a in (boxes, valid, cls)]
    want = nms.greedy_nms(*cpu[:2], thresh, cpu[2])
    dev = [a.to(cuda) if a is not None else None for a in cpu]
    before = nms.greedy_nms.launches
    got = nms.greedy_nms(*dev[:2], thresh, dev[2])
    torch.cuda.synchronize()
    assert nms.greedy_nms.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("topk", [1, 13, 64, 400, 10000])
def test_kernel_topk(cuda, topk):
    rng = np.random.RandomState(topk)
    boxes, valid, cls = _case(rng, 2, 7236, scale=0.1)
    cpu = [torch.from_numpy(a) for a in (boxes, valid, cls)]
    want = nms.greedy_nms(*cpu[:2], 0.5, cpu[2], topk=topk)
    got = nms.greedy_nms(*(a.to(cuda) for a in cpu[:2]), 0.5,
                         cpu[2].to(cuda), topk=topk)
    assert torch.equal(got.cpu(), want)
    assert not want[:, topk:].any()


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    boxes = torch.rand(1, 8, 4, device=cuda)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        nms.greedy_nms(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        nms.greedy_nms(boxes, valid.cpu(), 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DETECTION_CASES, ids=case_id)
def test_detection_case_on_the_card(cuda, case):
    got, ggot, where = run_case(mx.nd, mx.autograd, case, mx.gpu(0))
    want, gwant, _ = run_case(mx.nd, mx.autograd, case, mx.cpu())
    assert all(c == mx.gpu(0) for c in where)
    compare(case, got, want, case.name)
    if case.grad:
        compare(case, ggot, gwant, f"{case.name} gradient")


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(id_index=0, topk=400),
                                dict(id_index=0, force_suppress=True),
                                dict(valid_thresh=0.3, overlap_thresh=0.3)])
def test_box_nms_on_the_card(cuda, kw):
    rng = np.random.RandomState(1)
    d = rng.rand(8, 7236, 6).astype("float32")
    d[..., 0] = rng.randint(0, 20, (8, 7236))
    d[..., 1] = np.round(d[..., 1], 2)
    d[..., 4:] = d[..., 2:4] + rng.rand(8, 7236, 2) * 0.2
    want = co.box_nms(torch.from_numpy(d), **kw)
    got = co.box_nms(torch.from_numpy(d).to(cuda), **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_multibox_ops_on_the_card(cuda):
    """SSD-300's anchors (6 maps, 7236 of them) at batch 2: the anchors,
    the targets with hard negative mining and the detections, card
    against CPU."""
    rng = np.random.RandomState(2)
    maps = [(37, 4), (18, 6), (9, 6), (5, 6), (3, 4), (1, 4)]
    sizes = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961))
    outs = {}
    for device in ("cpu", cuda):
        anchors = [co.multibox_prior(torch.zeros(1, 1, m, m, device=device),
                                     sizes=s, ratios=(1, 2, 0.5))
                   for (m, _), s in zip(maps, sizes)]
        outs[str(device)] = [torch.cat(anchors, dim=1)]
    anchor = outs["cpu"][0]
    n = anchor.shape[1]
    assert n == 4 * (37 ** 2 + 18 ** 2 + 9 ** 2 + 5 ** 2 + 3 ** 2 + 1)
    lab = np.full((2, 3, 5), -1, "float32")
    lab[:, :2, 1:3] = rng.uniform(0.05, 0.6, (2, 2, 2))
    lab[:, :2, 3:] = lab[:, :2, 1:3] + 0.3
    lab[:, :2, 0] = rng.randint(0, 20, (2, 2))
    logits = rng.randn(2, 21, n).astype("float32")
    loc = (rng.randn(2, n * 4) * 0.3).astype("float32")
    prob = torch.softmax(torch.from_numpy(logits), dim=1).numpy()
    for device in ("cpu", cuda):
        a = outs[str(device)][0]
        lb, lg, lc, pb = _on(device, (lab, logits, loc, prob))
        outs[str(device)] += list(co.multibox_target(
            a, lb, lg, negative_mining_ratio=3.0))
        outs[str(device)].append(co.multibox_detection(
            pb, lc, a, nms_threshold=0.45, nms_topk=400))
    got = [t.cpu() for t in outs[str(cuda)]]
    want = outs["cpu"]
    for i in (0, 2, 3):                 # anchors, loc_mask, cls_target
        assert torch.equal(got[i], want[i])
    det, wdet = got[4], want[4]
    assert torch.equal(det[..., :2], wdet[..., :2])
    assert torch.equal((det == -1).all(-1), (wdet == -1).all(-1))
    for g, w in ((got[1], want[1]), (det[..., 2:], wdet[..., 2:])):
        assert (g - w).abs().max() <= 4e-7 * max(w.abs().max(), 1.0)
