"""``gluon.data`` in the port against the JAX package, on the CPU: the cases
of ``tests/test_io.py`` (datasets, samplers, ``DataLoader``, transforms)
run by both packages, plus the vision datasets on local files, the 14
transforms, ``DataLoader`` with threads and with two spawned workers under
every ``last_batch``, ``pin_memory`` and ``split_and_load``.

Batches are CPU NDArrays in the port whatever the current context (the
tests run outside any ``with mx.cpu():`` where they check that).  Every
pool is bounded by the loader's ``timeout``.
"""
import gzip
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.gluon.data.vision import transforms as T
from mxnet_tpu_torch.test_utils import with_gpus_hidden

JT = jmx.gluon.data.vision.transforms


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(i) for i in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("gdata")
    frec, fidx = str(d / "img.rec"), str(d / "img.idx")
    w = recordio.MXIndexedRecordIO(fidx, frec, "w")
    rng = np.random.RandomState(0)
    for i in range(12):
        img = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 5), i, 0), img, img_fmt=".png"))
    w.close()
    return frec


# ----------------------------------------------------- datasets and samplers
def test_datasets_match_jax(rec_file):
    X = np.random.RandomState(1).uniform(size=(10, 3)).astype("float32")
    y = np.arange(10, dtype="float32")
    for pkg in (mx, jmx):
        ds = pkg.gluon.data.ArrayDataset(X, y)
        assert len(ds) == 10
        np.testing.assert_array_equal(ds[3][0], X[3])
    simple = [pkg.gluon.data.SimpleDataset(list(range(10)))
              for pkg in (mx, jmx)]
    for fn in (lambda d: [d.transform(lambda v: 2 * v)[i] for i in
                          range(10)],
               lambda d: list(d.filter(lambda v: v % 3 == 0)),
               lambda d: list(d.take(4)),
               lambda d: list(d.transform(lambda v: v + 1, lazy=False))):
        assert fn(simple[0]) == fn(simple[1])
    pair = mx.gluon.data.ArrayDataset(X, y).transform_first(lambda v: v * 5)
    d3, l3 = pair[3]
    np.testing.assert_allclose(d3, X[3] * 5)
    assert l3 == 3.0
    raw = mx.gluon.data.RecordFileDataset(rec_file)
    jraw = jmx.gluon.data.RecordFileDataset(rec_file)
    assert len(raw) == len(jraw) == 12
    assert raw[7] == jraw[7]
    img = mx.gluon.data.vision.ImageRecordDataset(rec_file)
    jimg = jmx.gluon.data.vision.ImageRecordDataset(rec_file)
    for i in (0, 5, 11):
        (a, la), (b, lb) = img[i], jimg[i]
        assert a.context == mx.cpu() and a.dtype == np.uint8
        assert a.shape == (40, 36, 3) and la == lb
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    gray = mx.gluon.data.vision.ImageRecordDataset(rec_file, flag=0)
    np.testing.assert_array_equal(
        gray[2][0].asnumpy(),
        jmx.gluon.data.vision.ImageRecordDataset(rec_file, flag=0)[2][0]
        .asnumpy())


def test_samplers_match_jax():
    for pkg in (mx, jmx):
        s = pkg.gluon.data.SequentialSampler(5)
        assert list(s) == [0, 1, 2, 3, 4]
    orders = []
    for pkg in (mx, jmx):
        np.random.seed(3)
        orders.append(list(pkg.gluon.data.RandomSampler(50)))
    assert orders[0] == orders[1] and sorted(orders[0]) == list(range(50))
    for last in ("keep", "discard", "rollover"):
        got = mx.gluon.data.BatchSampler(mx.gluon.data.SequentialSampler(7),
                                         3, last)
        want = jmx.gluon.data.BatchSampler(
            jmx.gluon.data.SequentialSampler(7), 3, last)
        for _ in range(3):
            assert len(got) == len(want)
            assert list(got) == list(want)
    with pytest.raises(ValueError, match="last_batch"):
        list(mx.gluon.data.BatchSampler(range(5), 2, "nope"))


# ---------------------------------------------------------------- DataLoader
def _loader_epochs(pkg, ds, epochs=2, **kw):
    loader = pkg.gluon.data.DataLoader(ds, **kw)
    return [[_np(b) for b in loader] for _ in range(epochs)], len(loader)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_in_process_and_threads_match_jax(last_batch, shuffle):
    X = np.arange(40, dtype="float32").reshape(10, 4)
    y = np.arange(10, dtype="float32")
    runs = []
    for pkg, kw in ((mx, {}), (jmx, {}),
                    (mx, dict(num_workers=2, thread_pool=True))):
        np.random.seed(9)
        ds = pkg.gluon.data.ArrayDataset(X, y)
        runs.append(_loader_epochs(pkg, ds, batch_size=4, shuffle=shuffle,
                                   last_batch=last_batch, **kw))
    for got in (runs[0], runs[2]):
        assert got[1] == runs[1][1]
        for e_got, e_want in zip(got[0], runs[1][0]):
            assert len(e_got) == len(e_want)
            for b, w in zip(e_got, e_want):
                _same(b, w)


def test_dataloader_batchify_structures_and_context():
    class Pairs(mx.gluon.data.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return (np.full((2,), i, "float32"), np.float32(i * 10))

    batches = list(mx.gluon.data.DataLoader(Pairs(), batch_size=3))
    a, b = batches[0]
    assert a.shape == (3, 2) and b.shape == (3,)
    assert a.context == mx.cpu() and b.context == mx.cpu()
    np.testing.assert_allclose(b.asnumpy(), [0, 10, 20])
    nd_ds = mx.gluon.data.ArrayDataset(
        mx.nd.array(np.ones((4, 2)), ctx=mx.cpu()),
        mx.nd.array(np.arange(4), ctx=mx.cpu()))
    pinned = list(mx.gluon.data.DataLoader(nd_ds, batch_size=2,
                                           pin_memory=True))
    assert isinstance(pinned[0], tuple)
    assert all(x.context == mx.cpu() for x in pinned[0])
    with pytest.raises(ValueError):
        mx.gluon.data.DataLoader(nd_ds)
    with pytest.raises(ValueError):
        mx.gluon.data.DataLoader(nd_ds, 2, shuffle=True,
                                 sampler=mx.gluon.data.SequentialSampler(4))


def test_dataloader_spawned_workers_match_in_process(rec_file):
    """Two spawned workers give the in-process loader's batches over two
    epochs of ``last_batch="rollover"`` (the stateful one; every
    ``last_batch`` is held with threads above, and the sampler is the
    parent's in all three), as CPU NDArrays; the workers see no GPU.  The
    transforms live in the port's modules: a spawned worker imports what
    it unpickles, and this test module imports the JAX package."""
    fn = T.Compose([T.Resize(28), T.CenterCrop(24), T.ToTensor(),
                    T.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))])

    def dataset():
        return mx.gluon.data.vision.ImageRecordDataset(rec_file) \
            .transform_first(fn).transform(with_gpus_hidden)

    loader = mx.gluon.data.DataLoader(dataset(), batch_size=5,
                                      last_batch="rollover", num_workers=2,
                                      timeout=60)
    want, n = _loader_epochs(mx, dataset(), batch_size=5,
                             last_batch="rollover")
    got = [[_np(b) for b in loader] for _ in range(2)]
    assert len(loader) == n               # rollover's length is stateful
    for e_got, e_want in zip(got, want):
        assert len(e_got) == len(e_want)
        for b, w in zip(e_got, e_want):
            _same(b[:2], w[:2])
            assert (b[2] == 1.0).all()      # CUDA_VISIBLE_DEVICES == ""
    batch = next(iter(loader))
    assert batch[0].context == mx.cpu() and batch[0].shape == (5, 3, 24, 24)


def test_dataloader_timeout_is_bounded():
    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.SimpleDataset([0, 1]).transform(_sleep), batch_size=1,
        num_workers=1, thread_pool=True, timeout=0.5)
    with pytest.raises(RuntimeError, match="no batch within"):
        list(loader)


def _sleep(v):
    import time
    time.sleep(3)
    return v


# ---------------------------------------------------------------- transforms
def _img(h=36, w=40, seed=0, dtype="uint8"):
    a = np.random.RandomState(seed).rand(h, w, 3) * 255
    return a.astype(dtype)


DETERMINISTIC = [
    ("ToTensor", (), "uint8"),
    ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3)), "chw"),
    ("Cast", ("float16",), "uint8"),
    ("Resize", (16,), "uint8"),
    ("Resize", ((20, 14),), "float32"),
    ("CenterCrop", (20,), "uint8"),
    ("CenterCrop", (48,), "float32"),
    ("RandomBrightness", (0.0,), "float32"),
    ("RandomColorJitter", (), "float32"),
    ("RandomLighting", (0.0,), "float32"),
]


def _input(kind):
    if kind == "chw":
        return _img(dtype="float32").transpose(2, 0, 1) / 255.0
    return _img(dtype=kind)


@pytest.mark.parametrize("name,args,kind", DETERMINISTIC,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(DETERMINISTIC)])
def test_transform_matches_jax(name, args, kind):
    x = _input(kind)
    got = getattr(T, name)(*args)(mx.nd.array(x, ctx=mx.cpu(),
                                              dtype=x.dtype))
    want = getattr(JT, name)(*args)(jmx.nd.array(x, dtype=x.dtype))
    assert got.context == mx.cpu() and got.dtype == want.dtype
    _same(got, want)


def test_random_resized_crop_matches_jax_exactly():
    """It draws from numpy's global generator, as the JAX package does."""
    x = _img(48, 60)
    outs = []
    for pkg, tr in ((mx, T), (jmx, JT)):
        np.random.seed(4)
        t = tr.RandomResizedCrop(24, scale=(0.2, 1.0))
        outs.append([_np(t(pkg.nd.array(x, ctx=pkg.cpu(), dtype="uint8")))
                     for _ in range(2)])
        np.random.seed(4)
        outs.append(_np(tr.RandomResizedCrop((20, 16), scale=(0.9, 1.0),
                                             ratio=(3.0, 4.0))(
            pkg.nd.array(x, ctx=pkg.cpu(), dtype="uint8"))))
    for got, want in zip(outs[:2], outs[2:]):
        _same(got, want)


@pytest.mark.parametrize("name,args,kind", [
    ("RandomFlipLeftRight", (), "flip_lr"),
    ("RandomFlipTopBottom", (), "flip_tb"),
    ("RandomLighting", (0.1,), "shift"),
    ("RandomBrightness", (0.3,), "finite"),
    ("RandomContrast", (0.3,), "finite"),
    ("RandomSaturation", (0.3,), "finite"),
    ("RandomColorJitter", (0.1, 0.1, 0.1, 0.1), "finite")])
def test_random_transforms_outcomes(name, args, kind):
    from mxnet_tpu_torch.test_utils import image_random_outcome_ok
    x = _img(dtype="float32")
    mx.random.seed(6)
    t = getattr(T, name)(*args)
    outs = [t(mx.nd.array(x, ctx=mx.cpu())).asnumpy() for _ in range(24)]
    assert all(image_random_outcome_ok(kind, x, y) for y in outs)
    if kind.startswith("flip"):
        assert 0 < sum(not np.array_equal(y, x) for y in outs) < 24


def test_compose_fuses_hybrid_runs_and_matches_jax():
    parts = lambda tr: [tr.Resize(32), tr.CenterCrop(28),
                        tr.RandomResizedCrop(20), tr.ToTensor(),
                        tr.Normalize((0.5, 0.5, 0.5), (0.2, 0.2, 0.2)),
                        tr.Cast("float32")]
    fn, jfn = T.Compose(parts(T)), JT.Compose(parts(JT))
    kinds = [type(b).__name__ for b in fn._children.values()]
    assert kinds == [type(b).__name__ for b in jfn._children.values()]
    assert kinds == ["Resize", "CenterCrop", "RandomResizedCrop",
                     "HybridSequential"]
    # float pixels: a uint8 resize truncates, and a 1e-6 difference of the
    # two resizes at an integer would show as a whole step
    x = _img(36, 36, dtype="float32")
    outs = []
    for pkg, f in ((mx, fn), (jmx, jfn)):
        np.random.seed(2)
        outs.append(f(pkg.nd.array(x, ctx=pkg.cpu())))
    assert outs[0].shape == (3, 20, 20) and outs[0].dtype == np.float32
    _same(outs[0], outs[1])
    assert pickle.loads(pickle.dumps(fn)) is not None


# ------------------------------------------------------- vision datasets
def _write_idx(path, arr):
    code = {np.uint8: 0x08}[arr.dtype.type]
    head = np.array([(code << 8) | arr.ndim] + list(arr.shape), ">u4")
    with gzip.open(path, "wb") as f:
        f.write(head.tobytes() + arr.tobytes())


def test_vision_datasets_on_local_files_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _write_idx(mnist / "train-images-idx3-ubyte.gz",
               rng.randint(0, 256, (5, 28, 28)).astype("uint8"))
    _write_idx(mnist / "train-labels-idx1-ubyte.gz",
               rng.randint(0, 10, 5).astype("uint8"))
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (2, 3072))
                         .astype("uint8"),
                         b"labels": list(rng.randint(0, 10, 2))}, f)
    c100 = tmp_path / "c100" / "cifar-100-python"
    c100.mkdir(parents=True)
    for name in ("train", "test"):
        with open(c100 / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (3, 3072))
                         .astype("uint8"),
                         b"fine_labels": [1, 2, 3],
                         b"coarse_labels": [0, 1, 0]}, f)
    folder = tmp_path / "folder"
    import cv2
    for cls in ("cat", "dog"):
        (folder / cls).mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(folder / cls / f"{i}.png"),
                        rng.randint(0, 256, (8, 10, 3)).astype("uint8"))
    cases = [("MNIST", dict(root=str(mnist))),
             ("FashionMNIST", dict(root=str(mnist))),
             ("CIFAR10", dict(root=str(tmp_path / "cifar"))),
             ("CIFAR10", dict(root=str(tmp_path / "cifar"), train=False)),
             ("CIFAR100", dict(root=str(tmp_path / "c100"))),
             ("CIFAR100", dict(root=str(tmp_path / "c100"),
                               fine_label=False)),
             ("ImageFolderDataset", dict(root=str(folder)))]
    for name, kw in cases:
        ds = getattr(mx.gluon.data.vision, name)(**kw)
        jds = getattr(jmx.gluon.data.vision, name)(**kw)
        assert len(ds) == len(jds)
        for i in range(len(ds)):
            (a, la), (b, lb) = ds[i], jds[i]
            assert a.context == mx.cpu()
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
            assert la == lb
    plain = mx.gluon.data.vision.MNIST(root=str(mnist))
    tr = mx.gluon.data.vision.MNIST(root=str(mnist),
                                    transform=lambda d, l: (d, l + 1))
    assert tr[0][1] == plain[0][1] + 1
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        mx.gluon.data.vision.MNIST(root=str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        mx.gluon.data.vision.CIFAR10(root=str(tmp_path / "empty"))


# ------------------------------------------------------- moving host batches
def test_split_and_load_and_as_in_context():
    x = mx.nd.array(np.arange(24, dtype="float32").reshape(6, 4),
                    ctx=mx.cpu())
    parts = mx.gluon.utils.split_and_load(x, [mx.cpu(), mx.cpu(0)])
    jparts = jmx.gluon.utils.split_and_load(
        jmx.nd.array(np.arange(24, dtype="float32").reshape(6, 4)),
        [jmx.cpu(), jmx.cpu(0)])
    _same(parts, jparts)
    parts[0][:] = -1                         # a copy, not a view of x
    assert x.asnumpy().min() == 0
    odd = mx.gluon.utils.split_and_load(x, [mx.cpu()] * 4,
                                        even_split=False)
    assert [p.shape[0] for p in odd] == [1, 1, 1, 3]
    with pytest.raises(ValueError, match="evenly"):
        mx.gluon.utils.split_and_load(x, [mx.cpu()] * 4)
    y = x.as_in_context(mx.cpu())
    assert y is x
