"""NDArray surface of the port: for now, MXNet's ``.params`` file format on
torch tensors (counterpart of ``mx.nd.save`` / ``load`` /
``load_frombuffer``)."""
from .serialization import load, load_frombuffer, save  # noqa: F401
