"""SSD object detection (counterpart of ``mxnet_tpu/models/ssd.py``;
BASELINE config 4, "SSD-300 VGG16 — multibox/NMS custom ops"; reference
``example/ssd/``).

The JAX model's blocks, attributes and prefixes (``vgg_``, ``s1_`` ...
``s5_``, ``fc_``, ``extra_``, ``e{i}_``, ``cls_``, ``loc_``), so its
``save_parameters`` file loads here by structural name.  The backbone and
heads are convolutions (cuDNN); the anchors come from ``MultiBoxPrior``,
training targets from ``MultiBoxTarget`` and inference from
``MultiBoxDetection``, whose greedy NMS is the port's hand-written kernel
on the card (``ops/nms.py``).  The net has no BatchNorm.  ``device=None``
means the current context (the GPU).

Each block has a tensor ``forward`` (the path that runs) beside the
reference's ``hybrid_forward``, which ``export`` traces with ``F =
mx.sym``.
"""
from __future__ import annotations

import torch

from ..context import as_device
from ..gluon import Block, HybridBlock, nn
from ..gluon.block import _has_ndarray, _unwrap, _wrap
from ..gluon.loss import HuberLoss, SoftmaxCrossEntropyLoss
from ..ops.contrib_ops import (multibox_detection, multibox_prior,
                               multibox_target)
from ..ops.registry import amp_inputs

__all__ = ["SSD", "VGG16Base", "ssd_300_vgg16", "ssd_512_vgg16",
           "MultiBoxLoss", "detect"]


def _conv_block(out, num, channels, device, kernel=3, pad=1, dilation=1):
    for _ in range(num):
        out.add(nn.Conv2D(channels, kernel_size=kernel, padding=pad,
                          dilation=dilation, activation="relu",
                          device=device))


class VGG16Base(HybridBlock):
    """Reduced VGG16 backbone (SSD's convention: fc6/fc7 as dilated
    convolutions); returns the conv4_3 and fc7 feature maps."""

    def __init__(self, device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.stage1 = nn.HybridSequential(prefix="s1_")
            _conv_block(self.stage1, 2, 64, device)
            self.stage2 = nn.HybridSequential(prefix="s2_")
            _conv_block(self.stage2, 2, 128, device)
            self.stage3 = nn.HybridSequential(prefix="s3_")
            _conv_block(self.stage3, 3, 256, device)
            self.stage4 = nn.HybridSequential(prefix="s4_")
            _conv_block(self.stage4, 3, 512, device)
            self.stage5 = nn.HybridSequential(prefix="s5_")
            _conv_block(self.stage5, 3, 512, device)
            # fc6 (dilated) + fc7
            self.fc = nn.HybridSequential(prefix="fc_")
            self.fc.add(nn.Conv2D(1024, kernel_size=3, padding=6, dilation=6,
                                  activation="relu", device=device))
            self.fc.add(nn.Conv2D(1024, kernel_size=1, activation="relu",
                                  device=device))
            self.pool = nn.MaxPool2D(pool_size=2, strides=2)
            self.pool5 = nn.MaxPool2D(pool_size=3, strides=1, padding=1)

    def forward(self, x):
        x = self.pool(self.stage1(x))
        x = self.pool(self.stage2(x))
        x = self.pool(self.stage3(x))
        conv4_3 = self.stage4(x)
        x = self.pool5(self.stage5(self.pool(conv4_3)))
        return conv4_3, self.fc(x)

    def hybrid_forward(self, F, x):
        return self.forward(x)


class _ExtraLayer(HybridBlock):
    def __init__(self, c1, c2, stride, padding, device=None, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.conv1 = nn.Conv2D(c1, kernel_size=1, activation="relu",
                                   device=device)
            self.conv2 = nn.Conv2D(c2, kernel_size=3, strides=stride,
                                   padding=padding, activation="relu",
                                   device=device)

    def forward(self, x):
        return self.conv2(self.conv1(x))

    def hybrid_forward(self, F, x):
        return self.forward(x)


class SSD(HybridBlock):
    """Single-shot detector over a backbone giving multi-scale features.

    ``forward(x)`` -> ``(cls_preds (B, A, classes + 1), loc_preds (B, A*4),
    anchors (1, A, 4))``.
    """

    def __init__(self, num_classes, base=None,
                 sizes=((0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                        (0.54, 0.619), (0.71, 0.79), (0.88, 0.961)),
                 ratios=((1, 2, 0.5),) * 6, device=None, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self.num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        num_scales = len(sizes)
        with self.name_scope():
            self.base = base if base is not None else \
                VGG16Base(device, prefix="vgg_")
            self.extras = nn.HybridSequential(prefix="extra_")
            extra_cfg = [(256, 512, 2, 1), (128, 256, 2, 1),
                         (128, 256, 1, 0), (128, 256, 1, 0)]
            for i, (c1, c2, s, p) in enumerate(
                    extra_cfg[:max(0, num_scales - 2)]):
                self.extras.add(_ExtraLayer(c1, c2, s, p, device,
                                            prefix=f"e{i}_"))
            self.class_predictors = nn.HybridSequential(prefix="cls_")
            self.box_predictors = nn.HybridSequential(prefix="loc_")
            for i in range(num_scales):
                a = len(sizes[i]) + len(ratios[i]) - 1
                self.class_predictors.add(nn.Conv2D(
                    a * (num_classes + 1), kernel_size=3, padding=1,
                    device=device))
                self.box_predictors.add(nn.Conv2D(
                    a * 4, kernel_size=3, padding=1, device=device))

    def _features(self, x):
        conv4_3, fc7 = self.base(x)
        feats = [conv4_3, fc7]
        y = fc7
        for blk in self.extras._children.values():
            y = blk(y)
            feats.append(y)
        return feats[:len(self._sizes)]

    def forward(self, x):
        cls_preds, loc_preds, anchors = [], [], []
        cls_blocks = list(self.class_predictors._children.values())
        loc_blocks = list(self.box_predictors._children.values())
        for i, feat in enumerate(self._features(x)):
            cls_preds.append(cls_blocks[i](feat).permute(0, 2, 3, 1)
                             .flatten(1))
            loc_preds.append(loc_blocks[i](feat).permute(0, 2, 3, 1)
                             .flatten(1))
            anchors.append(multibox_prior(feat, sizes=self._sizes[i],
                                          ratios=self._ratios[i]))
        cls_pred = torch.cat(cls_preds, dim=1)
        return (cls_pred.reshape(cls_pred.shape[0], -1, self.num_classes + 1),
                torch.cat(loc_preds, dim=1), torch.cat(anchors, dim=1))

    def hybrid_forward(self, F, x):
        cls_preds, loc_preds, anchors = [], [], []
        cls_blocks = list(self.class_predictors._children.values())
        loc_blocks = list(self.box_predictors._children.values())
        for i, feat in enumerate(self._features(x)):
            cp = cls_blocks[i](feat)      # (B, A*(C+1), H, W)
            lp = loc_blocks[i](feat)
            cls_preds.append(F.flatten(F.transpose(cp, axes=(0, 2, 3, 1))))
            loc_preds.append(F.flatten(F.transpose(lp, axes=(0, 2, 3, 1))))
            anchors.append(F.contrib.MultiBoxPrior(
                feat, sizes=self._sizes[i], ratios=self._ratios[i]))
        cls_pred = F.concat(*cls_preds, dim=1)
        loc_pred = F.concat(*loc_preds, dim=1)
        anchor = F.concat(*anchors, dim=1)
        cls_pred = F.reshape(cls_pred, shape=(0, -1, self.num_classes + 1))
        return cls_pred, loc_pred, anchor


class MultiBoxLoss(Block):
    """SSD's training loss: softmax cross-entropy on the matched classes
    plus smooth L1 on the box offsets, the targets from
    ``MultiBoxTarget`` with hard negative mining.  An ignored anchor's
    target of -1 is clipped to class 0 by the cross-entropy's pick, as
    MXNet's ``pick`` clips, so it trains as background, as in the JAX
    package.  Returns (loss, cls_target, loc_target), NDArrays for NDArray
    inputs."""

    def __init__(self, negative_mining_ratio=3.0, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._ratio = negative_mining_ratio
        self._cls_loss = SoftmaxCrossEntropyLoss()
        self._loc_loss = HuberLoss()

    def forward(self, cls_pred, loc_pred, anchor, labels):
        wrap = _has_ndarray((cls_pred, loc_pred, anchor, labels), {})
        cls_pred, loc_pred, anchor, labels = _unwrap(
            (cls_pred, loc_pred, anchor, labels))
        loc_target, loc_mask, cls_target = multibox_target(
            anchor, labels, cls_pred.transpose(1, 2),
            negative_mining_ratio=self._ratio, overlap_threshold=0.5)
        cls_loss = self._cls_loss(cls_pred.reshape(-1, cls_pred.shape[-1]),
                                  cls_target.reshape(-1))
        loc_loss = self._loc_loss(loc_pred * loc_mask, loc_target * loc_mask)
        out = (cls_loss.mean() + loc_loss.mean(), cls_target, loc_target)
        return _wrap(out) if wrap else out


def ssd_300_vgg16(num_classes=20, **kwargs):
    return SSD(num_classes, **kwargs)


def ssd_512_vgg16(num_classes=20, **kwargs):
    sizes = ((0.07, 0.1025), (0.15, 0.2121), (0.3, 0.3674), (0.45, 0.5196),
             (0.6, 0.6708), (0.75, 0.8216), (0.9, 0.9721))
    return SSD(num_classes, sizes=sizes, ratios=((1, 2, 0.5),) * 7, **kwargs)


def detect(net, x, nms_threshold=0.45, force_suppress=False, nms_topk=400):
    """Inference decode (``example/ssd/demo.py``'s path): the class
    softmax, then ``MultiBoxDetection`` (B, A, 6); an NDArray for an
    NDArray input."""
    cls_pred, loc_pred, anchor = _unwrap(net(x))
    logits, = amp_inputs("softmax", cls_pred.transpose(1, 2))
    out = multibox_detection(torch.softmax(logits, dim=1), loc_pred, anchor,
                             nms_threshold=nms_threshold,
                             force_suppress=force_suppress,
                             nms_topk=nms_topk)
    return _wrap(out) if _has_ndarray((x,), {}) else out
