"""``mx.nd.image``, the device prologue and ``mx.image`` in the port against
the JAX package, on the CPU.

- Every deterministic image op (``test_utils.IMAGE_CASES``, the random ones
  with a degenerate range) equals the JAX package's within rtol 1e-5 and
  atol 1e-6.
- The random image ops draw from the port's torch generator: held by the
  moments of what they draw (5 standard errors over 2000 draws), by their
  possible outcomes, and by a seed giving the same stream.
- ``DeviceAugmenter`` equals the JAX package's ``image_augment`` within
  rtol 1e-5 and atol 1e-4 (the JAX pipeline test's tolerance), keeps one
  cache entry per (shape, dtype), and equals the host-augmented batch of
  ``ImageRecordIter``.
- ``mx.image``: decode, resize and crops, the augmenters under seeded
  ``random``/numpy generators, ``CreateAugmenter`` and ``ImageIter`` over a
  ``.rec`` and over a ``.lst`` of image files equal the JAX package's.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.image import DeviceAugmenter as JDeviceAugmenter

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio, telemetry
from mxnet_tpu_torch.image import DeviceAugmenter
from mxnet_tpu_torch.test_utils import (IMAGE_CASES, IMAGE_RANDOM_CASES,
                                        case_id, compare,
                                        image_random_outcome_ok, run_case)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", IMAGE_CASES, ids=case_id)
def test_image_op_matches_jax(case):
    got, _, where = run_case(mx.nd, mx.autograd, case, mx.cpu())
    want, _, _ = run_case(jmx.nd, jmx.autograd, case, jmx.cpu())
    assert all(c == mx.cpu() for c in where)
    compare(case, got, want, case.name)


def test_facade_and_table():
    names = {"to_tensor", "normalize", "resize", "augment", "crop",
             "flip_left_right", "flip_top_bottom", "random_flip_left_right",
             "random_flip_top_bottom", "random_brightness",
             "random_contrast", "random_saturation", "random_hue",
             "random_lighting", "random_color_jitter", "adjust_lighting"}
    assert all(callable(getattr(mx.nd.image, n)) for n in names)
    jnames = {n for n in dir(jmx.nd.image) if not n.startswith("_")}
    assert names <= jnames


# ----------------------------------------------------------- random image ops
DRAWS = 2000


def _within(values, mean, var):
    se = np.sqrt(var / len(values))
    return abs(values.mean() - mean) <= 5 * se + 1e-6


@pytest.mark.parametrize("op,lo,hi", [
    ("random_brightness", 0.6, 1.4), ("random_contrast", 0.5, 1.5),
    ("random_saturation", 0.8, 1.3), ("random_hue", -0.3, 0.3)])
def test_random_factor_ops_by_moments(op, lo, hi):
    """The factor a draw applied, recovered from the output, is uniform on
    [lo, hi]: its mean within 5 standard errors, its range inside."""
    mx.random.seed(3)
    x = mx.nd.array(np.array([[[40.0, 90.0, 200.0]]], "float32"))
    fn = getattr(mx.nd.image, op)
    fs = []
    for _ in range(DRAWS):
        y = fn(x, lo, hi).asnumpy()[0, 0]
        if op == "random_brightness":
            fs.append(y[0] / 40.0)
        elif op == "random_hue":
            fs.append(None)
            continue
        else:
            # f * x + (1 - f) * gray is linear in f: solve on channel 0
            gray = 110.0 if op == "random_contrast" else \
                0.299 * 40 + 0.587 * 90 + 0.114 * 200
            fs.append((y[0] - gray) / (40.0 - gray))
    if op == "random_hue":
        # the rotation keeps luma (Y of YIQ) and the chroma's length
        return _hue_invariants(x, lo, hi)
    fs = np.asarray(fs)
    assert fs.min() >= lo - 1e-4 and fs.max() <= hi + 1e-4
    assert _within(fs, (lo + hi) / 2, (hi - lo) ** 2 / 12)


def _hue_invariants(x, lo, hi):
    tyiq = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                     [0.211, -0.523, 0.311]])
    src = tyiq @ x.asnumpy()[0, 0]
    angles = []
    for _ in range(200):
        yiq = tyiq @ mx.nd.image.random_hue(x, lo, hi).asnumpy()[0, 0]
        # MXNet's YIQ matrices are rounded to 3 digits, so the round trip
        # keeps luma to ~1e-3 of it, not exactly
        assert abs(yiq[0] - src[0]) < 1e-3 * abs(src[0])
        angles.append(np.arctan2(yiq[2], yiq[1]) -
                      np.arctan2(src[2], src[1]))
    angles = (np.asarray(angles) + np.pi) % (2 * np.pi) - np.pi
    assert angles.min() >= lo * np.pi - 2e-2
    assert angles.max() <= hi * np.pi + 2e-2
    assert _within(angles / np.pi, (lo + hi) / 2, (hi - lo) ** 2 / 12)


def test_random_lighting_by_moments():
    """delta = eigvec @ (alpha * eigval), alpha ~ N(0, std): the alpha
    recovered from the shift has mean 0 and variance std^2."""
    mx.random.seed(4)
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    x = mx.nd.zeros((1, 1, 3))
    alphas = np.stack([np.linalg.solve(eigvec * eigval,
                                       mx.nd.image.random_lighting(
                                           x, 0.1).asnumpy()[0, 0])
                       for _ in range(DRAWS)])
    for k in range(3):
        assert _within(alphas[:, k], 0.0, 0.01)
        assert abs(alphas[:, k].var() - 0.01) < 5 * 0.01 * np.sqrt(
            2 / DRAWS)


@pytest.mark.parametrize("op,attrs,kind", IMAGE_RANDOM_CASES)
def test_random_ops_outcomes_and_seeded_stream(op, attrs, kind):
    x = np.random.RandomState(5).uniform(0, 255, (4, 5, 3)).astype(
        "float32")
    fn = getattr(mx.nd, op)

    def draws(seed, n=40):
        mx.random.seed(seed)
        return [fn(mx.nd.array(x), **attrs).asnumpy() for _ in range(n)]

    a = draws(11)
    assert all(image_random_outcome_ok(kind, x, y) for y in a)
    for y, z in zip(a, draws(11)):
        np.testing.assert_array_equal(y, z)
    if kind.startswith("flip"):
        flipped = sum(not np.array_equal(y, x) for y in a)
        assert 0 < flipped < len(a)


# ------------------------------------------------------------ device prologue
@pytest.mark.parametrize("rand_crop", [True, False])
def test_device_augmenter_matches_jax(rand_crop):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (6, 3, 20, 23)).astype("uint8")
    flips = rng.rand(6) < 0.5
    crops = rng.rand(6, 2)
    crops[0] = [0.999999, 0.0]              # the last offset
    kw = dict(mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
              scale=0.5, rand_crop=rand_crop, rand_mirror=True)
    aug = DeviceAugmenter((16, 17), **kw)
    jaug = JDeviceAugmenter((16, 17), **kw)
    telemetry.enable()
    telemetry.reset()
    try:
        out = aug(mx.nd.array(x, dtype="uint8"), flips, crops)
        out2 = aug(x, flips, crops)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    want = np.asarray(jaug(x, flips, crops))
    assert out.shape == (6, 3, 16, 17) and out.dtype == np.float32
    # a numpy batch goes to the current context: the CPU scope here
    assert out2.device.type == "cpu"
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out2.numpy(), want, rtol=1e-5, atol=1e-4)
    assert aug.compile_misses == 1
    assert snap["counters"]["io.augment_compile_miss"] == 1
    assert snap["counters"]["io.augment_batches"] == 2


def test_device_augment_equals_host_augment(tmp_path):
    """The uint8 canvas and the prologue give the host-augmented batch
    (square images, where the canvas and the shorter-edge resize agree)."""
    path = str(tmp_path / "sq.rec")
    w = recordio.MXRecordIO(path, "w")
    rng = np.random.RandomState(1)
    for i in range(12):
        img = (rng.rand(40, 40, 3) * 255).astype("uint8")
        w.write(recordio.pack_img(recordio.IRHeader(0, float(i), i, 0), img,
                                  quality=90))
    w.close()
    kw = dict(path_imgrec=path, data_shape=(3, 28, 28), batch_size=4,
              rand_mirror=True, rand_crop=True, resize=34, seed=5,
              mean_r=10., mean_g=20., mean_b=30., std_r=2., std_g=3.,
              std_b=4., scale=0.5)
    dev = mx.io.ImageRecordIter(device_augment=True, **kw)
    host = mx.io.ImageRecordIter(**kw)
    n = 0
    for bd, bh in zip(dev, host):
        x = dev.augmenter(bd.data[0], bd.augment_flip, bd.augment_crop)
        np.testing.assert_allclose(x.asnumpy(), bh.data[0].asnumpy(),
                                   rtol=1e-5, atol=1e-4)
        n += 1
    assert n == 3 and dev.augmenter.compile_misses == 1
    with pytest.raises(ValueError, match="crop margin"):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 40, 40),
                              batch_size=4, rand_crop=True,
                              device_augment=True)


# ------------------------------------------------------------------ mx.image
def _jpg(h=32, w=48):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                    (xx + yy) * 255 // (h + w - 2)], 2).astype("uint8")
    _, payload = recordio.unpack(recordio.pack_img(
        recordio.IRHeader(0, 0.0, 0, 0), img[..., ::-1], quality=95))
    return img, payload


def test_decode_resize_and_crops_match_jax(tmp_path):
    img, payload = _jpg()
    a = mx.image.imdecode(payload)
    assert a.context == mx.cpu() and a.dtype == np.uint8
    np.testing.assert_array_equal(a.asnumpy(),
                                  jmx.image.imdecode(payload).asnumpy())
    np.testing.assert_array_equal(
        mx.image.imdecode(payload, to_rgb=False).asnumpy(),
        jmx.image.imdecode(payload, to_rgb=False).asnumpy())
    f = str(tmp_path / "a.jpg")
    with open(f, "wb") as fh:
        fh.write(payload)
    np.testing.assert_array_equal(mx.image.imread(f).asnumpy(),
                                  jmx.image.imread(f).asnumpy())
    with pytest.raises(Exception):
        mx.image.imdecode(b"not an image")
    src, jsrc = mx.image.imdecode(payload), jmx.image.imdecode(payload)
    for fn, args in [("imresize", (16, 20)), ("resize_short", (15,)),
                     ("fixed_crop", (4, 6, 20, 10, (10, 8))),
                     ("center_crop", ((24, 20),))]:
        got = getattr(mx.image, fn)(src, *args)
        want = getattr(jmx.image, fn)(jsrc, *args)
        if isinstance(got, tuple):
            assert got[1] == want[1]
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert mx.image.scale_down((640, 480), (720, 120)) == (640, 106)
    out = mx.image.color_normalize(src.astype("float32"),
                                   mx.nd.array([1.0, 2.0, 3.0]),
                                   np.array([2.0, 4.0, 8.0]))
    want = (a.asnumpy().astype("float32") - [1, 2, 3]) / [2, 4, 8]
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)
    assert want.shape == img.shape


AUG_CASES = [
    dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.2, contrast=0.2,
         saturation=0.2, hue=0.1, pca_noise=0.1),
    dict(resize=36, mean=np.array([1.0, 2.0, 3.0])),
]


@pytest.mark.parametrize("kw", AUG_CASES, ids=range(len(AUG_CASES)))
def test_augmenters_match_jax_under_the_same_seeds(kw):
    img, payload = _jpg(48, 56)
    augs = mx.image.CreateAugmenter((3, 32, 32), **kw)
    jaugs = jmx.image.CreateAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in augs] == \
        [type(a).__name__ for a in jaugs]
    assert [a.dumps() for a in augs] == [a.dumps() for a in jaugs]
    outs = []
    for pkg, chain in ((mx, augs), (jmx, jaugs)):
        random.seed(5)
        np.random.seed(5)
        x = pkg.image.imdecode(payload)
        for _ in range(3):
            y = x
            for a in chain:
                y = a(y)
            outs.append(y.asnumpy())
    for got, want in zip(outs[:3], outs[3:]):
        assert got.shape == (32, 32, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_image_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    rec_path, idx_path = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
    lst = []
    for i in range(10):
        img = (rng.rand(36, 40, 3) * 255).astype("uint8")
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i % 3),
                                                           i, 0), img,
                                         quality=90))
        name = f"{i}.png"
        import cv2
        cv2.imwrite(str(tmp_path / name), img)
        lst.append(f"{i}\t{float(i % 4)}\t{name}")
    w.close()
    with open(tmp_path / "i.lst", "w") as f:
        f.write("\n".join(lst) + "\n")
    sources = [dict(path_imgrec=rec_path),
               dict(path_imgrec=rec_path, path_imgidx=idx_path,
                    shuffle=True),
               dict(path_imglist=str(tmp_path / "i.lst"),
                    path_root=str(tmp_path), shuffle=True)]
    for src in sources:
        kw = dict(batch_size=4, data_shape=(3, 32, 32), rand_crop=True,
                  rand_mirror=True, mean=True, **src)
        epochs = []
        for pkg in (mx, jmx):
            random.seed(2)
            np.random.seed(2)
            it = pkg.image.ImageIter(**kw)
            run = []
            for _ in range(2):
                run += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it]
                it.reset()
            epochs.append(run)
        assert len(epochs[0]) == len(epochs[1]) == 6
        for (x, y, p), (jx, jy, jp) in zip(*epochs):
            assert p == jp
            np.testing.assert_array_equal(y, jy)
            np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-3)
    b = mx.image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                           path_imgrec=rec_path).next()
    assert b.data[0].context == mx.cpu() and b.data[0].dtype == np.float32
