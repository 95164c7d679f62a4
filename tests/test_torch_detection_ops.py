"""The port's detection operators against the JAX package's, on the CPU:
``box_iou``, ``box_nms``, ``bipartite_matching``, ``MultiBoxPrior``,
``MultiBoxTarget`` and ``MultiBoxDetection`` (``mx.nd.contrib`` and
``mx.sym.contrib``), and the plain greedy NMS that ``csrc/nms.cu`` is held
against on the card.

Both packages get the same numpy inputs, made from a seed.  Outputs are
compared exactly, with one exception: the values that go through ``exp``,
``log`` or a division by a constant (``MultiBoxTarget``'s offsets,
``MultiBoxDetection``'s decoded boxes) may differ in the last bit, since
XLA's CPU ``exp``/``log`` and its multiply-by-reciprocal round otherwise
than torch's (about one in twelve of them, measured on 200,000 draws).
Those are held within 4 ulp (rtol 5e-7 of the largest); every discrete
output (ids, scores, order, the keep pattern, masks, class targets) is
held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import contrib_ops as jops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.ops import nms
from mxnet_tpu_torch.test_utils import (DETECTION_CASES, case_id, compare,
                                        run_case)

jnd = jmx.nd
CPU = mx.cpu()
ULP_RTOL = 5e-7


def _p(a):
    return mx.nd.array(np.asarray(a), ctx=CPU)


def _boxes(rng, shape, scale=0.5):
    b = rng.rand(*shape, 4).astype("float32")
    b[..., 2:] = b[..., :2] + rng.rand(*shape, 2).astype("float32") * scale
    return b


def _close_ulp(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP_RTOL * max(np.abs(want).max(), 1.0))


# ------------------------------------------------- the shared op cases
@pytest.mark.parametrize("case", DETECTION_CASES, ids=case_id)
def test_detection_case_matches_jax(case):
    """``test_utils.DETECTION_CASES`` (which phase 12 and the GPU tests run
    on the card) through both packages' ``mx.nd``, outputs and gradients
    at the cases' tolerances."""
    got, ggot, where = run_case(mx.nd, ag, case, CPU)
    want, gwant, _ = run_case(jnd, jmx.autograd, case, jmx.cpu())
    assert all(c == CPU for c in where)
    compare(case, got, want, case.name)
    if case.grad:
        compare(case, ggot, gwant, f"{case.name} gradient")


# --------------------------------------------------------------- box_iou
@pytest.mark.parametrize("fmt,lead", [("center", ()), ("corner", (2, 3))])
def test_box_iou_and_its_gradient_match_jax(fmt, lead):
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, lead + (5,)), _boxes(rng, lead + (7,))
    a[..., 0, :] = b[..., 0, :]                 # ties in every max/min
    if fmt == "center":
        a[..., 2:] -= a[..., :2]
        b[..., 2:] -= b[..., :2]
    want = jnd.contrib.box_iou(jnd.array(a), jnd.array(b), format=fmt)
    got = mx.nd.contrib.box_iou(_p(a), _p(b), format=fmt)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())

    hg = rng.randn(*want.shape).astype("float32")
    ja, jb = jnd.array(a), jnd.array(b)
    ja.attach_grad()
    jb.attach_grad()
    with jmx.autograd.record():
        out = jnd.contrib.box_iou(ja, jb, format=fmt)
    out.backward(jnd.array(hg))
    pa, pb = _p(a), _p(b)
    pa.attach_grad()
    pb.attach_grad()
    with ag.record():
        out = mx.nd.contrib.box_iou(pa, pb, format=fmt)
    out.backward(_p(hg))
    # at a pair of equal boxes (IoU 1, a maximum) the gradient's terms, of
    # the order of the head gradient over the union, cancel to ~1e-7, where
    # the order of the sums and XLA's vjp of the division show: atol 1e-4
    # of the largest gradient element
    for g, w in ((pa.grad, ja.grad), (pb.grad, jb.grad)):
        w = w.asnumpy()
        np.testing.assert_allclose(g.asnumpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max())


# ------------------------------------------------------------- greedy NMS
@pytest.mark.parametrize("thresh,ids", [(0.5, False), (0.3, True),
                                        (-0.1, True)])
def test_plain_greedy_nms_matches_jax(thresh, ids):
    """The plain version (the kernel's reference on the card) against the
    JAX package's ``_greedy_nms_mask``, image by image: overlapping boxes,
    invalid rows, NaN coordinates, class ids and a negative threshold
    (where boxes of other classes, IoU 0, suppress)."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, (3, 70), scale=0.3)
    boxes[0, 5] = np.nan
    valid = rng.rand(3, 70) > 0.2
    cls = rng.randint(0, 3, (3, 70)).astype("float32")
    got = nms._reference(torch.from_numpy(boxes), torch.from_numpy(valid),
                         thresh, torch.from_numpy(cls) if ids else None)
    for i in range(3):
        want = jops._greedy_nms_mask(
            jnp.asarray(boxes[i]), None, jnp.asarray(valid[i]), thresh,
            cls_id=jnp.asarray(cls[i]) if ids else None)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert nms.greedy_nms.launches == 0


def test_greedy_nms_topk_and_meta():
    """Rows past ``topk`` are invalid: the wrapper's cut equals the full
    loop over the masked rows; shape inference runs on meta tensors."""
    rng = np.random.RandomState(3)
    boxes = torch.from_numpy(_boxes(rng, (2, 40), scale=0.4))
    valid = torch.ones(2, 40, dtype=torch.bool)
    cut = nms.greedy_nms(boxes, valid, 0.4, topk=13)
    masked = valid.clone()
    masked[:, 13:] = False
    np.testing.assert_array_equal(cut.numpy(),
                                  nms._reference(boxes, masked, 0.4).numpy())
    meta = nms.greedy_nms(boxes.to("meta"), valid.to("meta"), 0.4, topk=13)
    assert meta.shape == (2, 40) and meta.dtype == torch.bool


# ---------------------------------------------------------------- box_nms
def _dets(rng, lead, n=60, k=6):
    d = rng.rand(*lead, n, k).astype("float32")
    d[..., 0] = rng.randint(0, 3, lead + (n,))
    d[..., 1] = np.round(d[..., 1], 1)            # ties in the scores
    d[..., 2:6] = _boxes(rng, lead + (n,), scale=0.4)
    return d


_NMS_CASES = [
    ((), {}),
    ((2,), dict(overlap_thresh=0.3)),
    ((2, 3), dict(id_index=0)),
    ((2,), dict(id_index=0, background_id=1)),
    ((2,), dict(id_index=0, force_suppress=True)),
    ((2,), dict(topk=17, id_index=0)),
    ((2,), dict(valid_thresh=0.45, overlap_thresh=0.2)),
    ((2,), dict(in_format="center", out_format="center")),
    ((2,), dict(id_index=0, background_id=0, topk=25, valid_thresh=0.2,
                force_suppress="True", overlap_thresh="0.4")),
]


@pytest.mark.parametrize("lead,kw", _NMS_CASES)
def test_box_nms_matches_jax(lead, kw):
    rng = np.random.RandomState(4)
    d = _dets(rng, lead)
    want = jnd.contrib.box_nms(jnd.array(d), **kw).asnumpy()
    got = mx.nd.contrib.box_nms(_p(d), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()


def test_box_nms_other_columns_and_gradient():
    """``coord_start``/``score_index``/``id_index`` elsewhere in a wider
    row, and the gradient (to the kept rows, as ``jax.vjp`` gives it)."""
    rng = np.random.RandomState(5)
    d = _dets(rng, (2,), k=6)
    wide = np.concatenate([d[..., 2:6], d[..., 1:2], rng.rand(2, 60, 1)
                           .astype("float32"), d[..., :1]], axis=-1)
    kw = dict(coord_start=0, score_index=4, id_index=6, overlap_thresh=0.3)
    hg = rng.randn(*wide.shape).astype("float32")
    jx = jnd.array(wide)
    jx.attach_grad()
    with jmx.autograd.record():
        want = jnd.contrib.box_nms(jx, **kw)
    want.backward(jnd.array(hg))
    px = _p(wide)
    px.attach_grad()
    with ag.record():
        got = mx.nd.contrib.box_nms(px, **kw)
    got.backward(_p(hg))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(px.grad.asnumpy(), jx.grad.asnumpy())


def test_box_iou_and_nms_operator_sweep_case():
    """``tests/test_operator_sweep.py``'s case, in the port."""
    boxes = np.array([[0, 0, 2, 2], [1, 1, 3, 3], [10, 10, 12, 12]],
                     np.float32)
    iou = mx.nd.contrib.box_iou(_p(boxes), _p(boxes)).asnumpy()
    np.testing.assert_allclose(np.diag(iou), 1.0, rtol=1e-5)
    np.testing.assert_allclose(iou[0, 1], 1.0 / 7.0, rtol=1e-4)
    assert iou[0, 2] == 0
    dets = np.array([[0, 0.9, 0, 0, 2, 2],
                     [0, 0.8, 1, 1, 3, 3],
                     [1, 0.7, 10, 10, 12, 12]], np.float32)
    out = mx.nd.contrib.box_nms(_p(dets), overlap_thresh=0.1).asnumpy()
    assert len(out[out[:, 0] >= 0]) == 2


# ---------------------------------------------------- bipartite_matching
@pytest.mark.parametrize("shape,kw", [((4, 6), dict(threshold=0.3)),
                                      ((3, 5, 4), dict(threshold=0.5)),
                                      ((2, 4, 4), dict(is_ascend=True,
                                                       threshold=0.6))])
def test_bipartite_matching_matches_jax(shape, kw):
    rng = np.random.RandomState(6)
    s = rng.rand(*shape).astype("float32")
    want = jnd.contrib.bipartite_matching(jnd.array(s), **kw)
    got = mx.nd.contrib.bipartite_matching(_p(s), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_bipartite_matching_operator_sweep_case():
    score = np.array([[0.9, 0.1], [0.8, 0.7]], np.float32)
    rows, _ = mx.nd.contrib.bipartite_matching(_p(score), threshold=0.05)
    assert list(rows.asnumpy()) == [0, 1]


# ---------------------------------------------------------- MultiBoxPrior
_PRIOR_CASES = [((4, 4), dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5))),
                ((5, 7), dict(sizes="(0.5, 0.25)", ratios="(1, 2)",
                              clip=True)),
                ((3, 6), dict(sizes=(0.3,), ratios=(1, 3, 1 / 3),
                              steps="(0.1, 0.2)", offsets="(0.3, 0.6)")),
                ((37, 37), dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5)))]


@pytest.mark.parametrize("hw,kw", _PRIOR_CASES)
def test_multibox_prior_matches_jax_with_zero_gradient(hw, kw):
    x = np.random.RandomState(7).rand(2, 3, *hw).astype("float32")
    want = jnd.contrib.MultiBoxPrior(jnd.array(x), **kw).asnumpy()
    px = _p(x)
    px.attach_grad()
    with ag.record():
        got = mx.nd.contrib.MultiBoxPrior(px, **kw)
    got.backward(_p(np.ones(want.shape, "float32")))
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert not px.grad.asnumpy().any()


def test_multibox_prior_sweep_cases():
    """``tests/test_operator_sweep.py``'s property case and
    ``tests/test_operator_grad_contracts3.py``'s symbolic layout case."""
    a = mx.nd.contrib.MultiBoxPrior(_p(np.zeros((1, 3, 4, 4), "float32")),
                                    sizes=(0.5, 0.25), ratios=(1, 2))
    a = a.asnumpy()[0]
    assert a.shape == (4 * 4 * 3, 4)
    cx = (a[:, 0] + a[:, 2]) / 2
    assert np.allclose(sorted(set(np.round(cx, 4))),
                       [0.125, 0.375, 0.625, 0.875], atol=1e-3)
    sym = mx.sym.contrib.MultiBoxPrior(mx.sym.Variable("data"), sizes=(0.5,),
                                       ratios=(1.0,))
    out = sym.eval(ctx=CPU, data=_p(np.zeros((1, 3, 2, 2), "float32")))
    out = out[0].asnumpy()
    assert out.shape == (1, 4, 4)
    np.testing.assert_allclose(out[0, 0], [0.0, 0.0, 0.5, 0.5], atol=1e-5)


# --------------------------------------------------------- MultiBoxTarget
def _anchors(hw=(8, 8)):
    return jnd.contrib.MultiBoxPrior(jnd.zeros((1, 3) + hw),
                                     sizes=(0.2, 0.3),
                                     ratios=(1, 2, 0.5)).asnumpy()


def _labels():
    """Three images, up to 4 boxes, padded with -1 after the real rows;
    image 2's two boxes are the same box (they share a best anchor)."""
    lab = np.full((3, 4, 5), -1, "float32")
    lab[0, :2] = [[0, .1, .1, .5, .6], [2, .4, .3, .9, .8]]
    lab[1, :3] = [[1, .2, .2, .3, .4], [0, .5, .5, .95, .9],
                  [1, .05, .6, .4, .95]]
    lab[2, :2] = [[1, .3, .3, .6, .7], [2, .3, .3, .6, .7]]
    return lab


_TARGET_CASES = [{}, dict(negative_mining_ratio=3.0),
                 dict(negative_mining_ratio=3.0, minimum_negative_samples=40,
                      ignore_label=-2.0, overlap_threshold=0.3,
                      negative_mining_thresh=0.4),
                 dict(variances="(0.2, 0.2, 0.1, 0.1)",
                      overlap_threshold="0.6")]


@pytest.mark.parametrize("kw", _TARGET_CASES)
def test_multibox_target_matches_jax(kw):
    """Real boxes first, padded rows after, none of whose best anchor (0)
    is a real box's: there the JAX result does not depend on the order of
    its scatter.  Image 2's two boxes share a best anchor (the later one
    wins in both).  Hard negatives tie at -1 for every non-candidate."""
    anc, lab = _anchors(), _labels()
    cp = np.random.RandomState(8).randn(3, 4, anc.shape[1]) \
        .astype("float32")
    # the JAX package's targets are taken at the default ignore_label and
    # its ignored anchors relabelled (another label costs it a recompile)
    ignore = kw.get("ignore_label", -1.0)
    want = jnd.contrib.MultiBoxTarget(
        jnd.array(anc), jnd.array(lab), jnd.array(cp),
        **{k: v for k, v in kw.items() if k != "ignore_label"})
    got = mx.nd.contrib.MultiBoxTarget(_p(anc), _p(lab), _p(cp), **kw)
    want = [w.asnumpy() for w in want]
    want[2] = np.where(want[2] == -1, ignore, want[2])
    got = [g.asnumpy() for g in got]
    _close_ulp(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[2][2] == 3).any()                 # the later box's class
    if kw.get("negative_mining_ratio", -1) > 0:
        assert (got[2] == float(kw.get("ignore_label", -1))).any()


@pytest.mark.parametrize("padded_first", [False, True])
def test_multibox_target_padded_rows_never_write(padded_first):
    """MXNet 1.5's contract (``multibox_target.cc`` skips padded rows): a
    box keeps its forced match on anchor 0 whatever the order of its label
    rows.  The JAX package's scatter lets a padded row after the box erase
    it (``mxnet_tpu/ops/contrib_ops.py:223-227``, a reference-side
    defect); with the box after every padded row it agrees with the
    port.  The
    probe's anchors ``[[0,0,.5,.5],[.5,.5,1,1],[0,.5,.5,1]]`` and box
    ``[1, 0,0,.3,.3]`` at threshold 0.5 lead the anchors of the other
    cases, the rest tiny boxes far from it."""
    anc = np.tile(np.array([.97, .97, .98, .98], "float32"),
                  (1, _anchors().shape[1], 1))
    anc[0, :3] = [[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]
    lab = np.full((3, 4, 5), -1, "float32")
    lab[:, 3 if padded_first else 0] = [1, 0, 0, .3, .3]
    cp = np.zeros((3, 4, anc.shape[1]), "float32")
    got = mx.nd.contrib.MultiBoxTarget(_p(anc), _p(lab), _p(cp),
                                       overlap_threshold=0.5)
    cls_t = got[2].asnumpy()
    np.testing.assert_array_equal(cls_t[:, :3], [[2, 0, 0]] * 3)
    assert not cls_t[:, 3:].any()
    np.testing.assert_array_equal(got[1].asnumpy()[:, :4], 1)
    want = jnd.contrib.MultiBoxTarget(jnd.array(anc), jnd.array(lab),
                                      jnd.array(cp), overlap_threshold=0.5)
    jax_cls = want[2].asnumpy()[:, :3]
    assert jax_cls.tolist() == [[2, 0, 0] if padded_first else [0, 0, 0]] * 3


def test_multibox_target_symbol_has_three_outputs():
    """``mx.sym.contrib.MultiBoxTarget`` binds with three visible outputs,
    each equal to ``mx.nd``'s."""
    anc, lab = _anchors((4, 4)), _labels()
    cp = np.random.RandomState(9).randn(3, 4, anc.shape[1]) \
        .astype("float32")
    s = mx.sym.contrib.MultiBoxTarget(
        mx.sym.var("anchor"), mx.sym.var("label"), mx.sym.var("cls_pred"),
        negative_mining_ratio=3.0)
    assert len(s.list_outputs()) == 3
    exe = s.bind(CPU, {"anchor": _p(anc), "label": _p(lab),
                       "cls_pred": _p(cp)}, grad_req="null")
    outs = exe.forward()
    want = mx.nd.contrib.MultiBoxTarget(_p(anc), _p(lab), _p(cp),
                                        negative_mining_ratio=3.0)
    assert len(outs) == 3
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.asnumpy(), w.asnumpy())


# ------------------------------------------------------ MultiBoxDetection
_DET_CASES = [{}, dict(nms_topk=60, nms_threshold=0.45),
              dict(force_suppress=True, threshold=0.2, clip=False),
              dict(background_id=2, nms_threshold="0.3",
                   variances="(0.1, 0.1, 0.2, 0.2)")]


@pytest.mark.parametrize("kw", _DET_CASES)
def test_multibox_detection_matches_jax(kw):
    """Probabilities rounded to 0.01 tie by the hundreds: the stable sort
    keeps their order in both packages."""
    anc = _anchors()
    rng = np.random.RandomState(10)
    logits = rng.randn(2, 4, anc.shape[1]).astype("float32")
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob = np.round(prob, 2).astype("float32")
    loc = (rng.randn(2, anc.shape[1] * 4) * 0.5).astype("float32")
    want = jnd.contrib.MultiBoxDetection(jnd.array(prob), jnd.array(loc),
                                         jnd.array(anc), **kw).asnumpy()
    got = mx.nd.contrib.MultiBoxDetection(_p(prob), _p(loc), _p(anc),
                                          **kw).asnumpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_array_equal((got == -1).all(-1), (want == -1).all(-1))
    _close_ulp(got[..., 2:], want[..., 2:])
    assert (got[..., 0] >= 0).any() and (got[..., 0] == -1).any()


class _Anchored(mx.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return F.contrib.MultiBoxPrior(x, sizes=(0.3, 0.4), ratios=(1, 2))


def test_f_contrib_inside_hybrid_forward_on_both_routes(tmp_path):
    """A user block's ``F.contrib.MultiBoxPrior``: eagerly (``F = mx.nd``)
    and traced (``F = mx.sym``) through ``export``, the imported block
    giving the same anchors."""
    x = _p(np.zeros((1, 3, 5, 6), "float32"))
    net = _Anchored()
    net.hybridize()
    eager = net(x).asnumpy()
    want = jnd.contrib.MultiBoxPrior(jnd.zeros((1, 3, 5, 6)), sizes=(0.3, 0.4),
                                     ratios=(1, 2)).asnumpy()
    np.testing.assert_array_equal(eager, want)
    sym_file, _ = net.export(str(tmp_path / "anchored"))
    imported = mx.gluon.SymbolBlock.imports(sym_file, ["data"], ctx=CPU)
    np.testing.assert_array_equal(imported(x).asnumpy(), eager)
