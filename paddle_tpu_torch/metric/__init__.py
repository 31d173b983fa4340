"""paddle.metric (``paddle_tpu/metric/__init__.py`` counterpart; parity:
`python/paddle/metric/metrics.py:183-594`) on torch tensors.

The per-batch arithmetic runs where the tensors are (the top-k and the
counts on the card for a model on the card); each `update` brings its
few counts to the host, where the running totals live as in the JAX
package.  Numpy arrays are taken too.  `Accuracy` reads the classes on
the last axis of any rank (a language model's [B, S, V] logits against
[B, S] labels); the JAX package's `compute` takes only 2-D scores.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """[N, maxk] float32: whether each of the top-k classes of each
        row of `pred` (classes on its last axis) is the row's label."""
        pred = _t(pred)
        label = _t(label, pred.device)
        if label.dim() == pred.dim() and label.shape[-1] > 1:
            label = label.argmax(-1)
        label = label.reshape(-1, 1)
        top = torch.topk(pred.reshape(-1, pred.shape[-1]), self.maxk,
                         dim=-1).indices
        return (top == label).float()

    def update(self, correct, *args):
        c = _t(correct)
        n = c.shape[0]
        nums = torch.stack([c[:, :k].sum() for k in self.topk]).tolist()
        res = []
        for i, num in enumerate(nums):
            self.total[i] += num
            self.count[i] += n
            res.append(num / n)
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


def _confusion(preds, labels):
    """(p, l): the 0/1 predictions (score > 0.5) and labels, flat."""
    p = (_t(preds) > 0.5).to(torch.int32).reshape(-1)
    return p, _t(labels, p.device).to(torch.int32).reshape(-1)


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, l = _confusion(preds, labels)
        tp, fp = torch.stack([((p == 1) & (l == 1)).sum(),
                              ((p == 1) & (l == 0)).sum()]).tolist()
        self.tp += tp
        self.fp += fp

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, l = _confusion(preds, labels)
        tp, fn = torch.stack([((p == 1) & (l == 1)).sum(),
                              ((p == 0) & (l == 1)).sum()]).tolist()
        self.tp += tp
        self.fn += fn

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _t(preds)
        if p.dim() == 2:
            p = p[:, -1]
        if p.dtype in (torch.bfloat16, torch.float16):
            p = p.float()
        l = _t(labels, p.device).reshape(-1)
        bins = torch.round(p * self.num_thresholds).to(torch.int64)
        bins = bins.clamp(0, self.num_thresholds)
        n = self.num_thresholds + 1
        pos = torch.bincount(bins[l != 0], minlength=n)
        neg = torch.bincount(bins[l == 0], minlength=n)
        self._stat_pos += pos.cpu().numpy()
        self._stat_neg += neg.cpu().numpy()

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * self._stat_neg[i] / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional accuracy (paddle.metric.accuracy): the top-k hit rate
    over the rows of `input`, a float32 scalar tensor on its device."""
    top = torch.topk(input, k, dim=-1).indices
    hit = (top == _t(label, input.device).reshape(-1, 1)).any(dim=-1)
    return hit.float().mean()


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
