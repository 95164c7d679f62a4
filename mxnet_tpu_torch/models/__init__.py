"""Models of the port."""
from . import bert, ssd  # noqa: F401
from .bert import BERTClassifier, BERTModel, get_bert_model  # noqa: F401
from .ssd import (SSD, MultiBoxLoss, VGG16Base, detect,  # noqa: F401
                  ssd_300_vgg16, ssd_512_vgg16)
