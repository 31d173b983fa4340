"""High-level Model API (``paddle_tpu/hapi/model.py`` counterpart;
parity: `python/paddle/hapi/model.py:1054` — Model.prepare / fit /
evaluate / predict / save / load with callbacks and metrics).

The network is a `torch.nn.Module` on its device; batches reach that
device through the `DataLoader` (one copy a batch), and numpy inputs
given to the single-batch calls are moved there.  ``amp_configs`` go to
the port's `amp`: O2 casts the network through `amp.decorate` (f32
master weights in the optimizer), and the train step runs under
`amp.auto_cast` at O1 and O2, as the JAX `train_batch` does; evaluation
and prediction run without it, as in JAX.

The JAX `prepare` wraps the network in `DataParallel` under an
initialized dp > 1 topology (:50-68); the port has no such topology
yet (ROADMAP C2.28).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import amp
from ..core.device import resolve_device
from ..framework.io_utils import load as fload, save as fsave
from .callbacks import CallbackList, ProgBarLogger


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(t):
    """An output as numpy: 16-bit floats widened to float32 (exact)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        """`device`: where batches go; by default the network's
        parameters' device (the CUDA device for a network without
        parameters)."""
        self.network = network
        p = next(network.parameters(), None)
        self.device = resolve_device(device) if device is not None or \
            p is None else p.device
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        # AMP (reference Model.prepare amp_configs): "O1"/"O2" or a dict
        # {"level": ..., "dtype": ...}; O2 decorates params to the compute
        # dtype, O1 autocasts per-op inside train_batch
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"
        if amp_configs:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
                self._amp_dtype = amp_configs.get("dtype", "bfloat16")
            if self._amp_level == "O2":
                self.network, self._optimizer = amp.decorate(
                    self.network, self._optimizer, level="O2",
                    dtype=self._amp_dtype)
        return self

    def _inputs(self, xs):
        """Tensors (numpy arrays too) on the model's device."""
        return [torch.from_numpy(np.asarray(x)).to(self.device)
                if isinstance(x, np.ndarray) else
                x.to(self.device) if isinstance(x, torch.Tensor) else x
                for x in _to_list(xs)]

    # --- single steps --------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._inputs(inputs)
        labels = self._inputs(labels)
        if self._amp_level in ("O1", "O2"):
            with amp.auto_cast(level=self._amp_level,
                               dtype=self._amp_dtype):
                outs = self.network(*inputs)
                losses = self._compute_loss(outs, labels)
        else:
            outs = self.network(*inputs)
            losses = self._compute_loss(outs, labels)
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        return [float(l.detach()) for l in losses], metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        labels = self._inputs(labels)
        with torch.no_grad():
            outs = self.network(*self._inputs(inputs))
            losses = self._compute_loss(outs, labels)
        metrics = self._update_metrics(outs, labels)
        return [float(l) for l in losses], metrics

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*self._inputs(inputs))
        return [_numpy(o) for o in _to_list(outs)]

    def _compute_loss(self, outs, labels):
        outs_l = _to_list(outs)
        if self._loss is None:
            return outs_l
        return _to_list(self._loss(*(outs_l + labels)))

    def _update_metrics(self, outs, labels):
        res = {}
        outs_l = _to_list(outs)
        for m in self._metrics:
            inp = m.compute(*(outs_l + labels))
            r = m.update(inp) if not isinstance(inp, (list, tuple)) else \
                m.update(*inp)
            res[m.name()] = r
        return res

    def _loader(self, data, batch_size, num_workers, **kw):
        from ..io import DataLoader, Dataset

        if not isinstance(data, Dataset):
            return data
        return DataLoader(data, batch_size=batch_size,
                          num_workers=num_workers, device=self.device, **kw)

    # --- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle=shuffle, drop_last=drop_last)
        eval_loader = None if eval_data is None else self._loader(
            eval_data, batch_size, num_workers)

        cbks = CallbackList(_to_list(callbacks) or
                            [ProgBarLogger(log_freq, verbose=verbose)])
        cbks.set_model(self)
        cbks.set_params({
            "epochs": epochs, "steps": self._len_or_none(train_loader),
            "verbose": verbose, "metrics": ["loss"] + [
                m.name() for m in self._metrics],
        })
        cbks.on_begin("train")
        it = 0
        done = False
        logs = {}
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            pending = 0
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                # gradient accumulation (reference accumulate_grad_batches):
                # grads add up across micro-batches; step every k-th
                pending += 1
                update = pending % max(1, accumulate_grad_batches) == 0
                losses, metrics = self.train_batch(inputs, labels,
                                                   update=update)
                logs = {"loss": losses, **metrics, "step": step}
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    done = True
                    break
            if pending % max(1, accumulate_grad_batches) != 0:
                # flush the tail micro-batches
                self._optimizer.step()
                self._optimizer.clear_grad()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, callbacks=callbacks,
                              verbose=verbose)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if self.stop_training or done:
                break
        cbks.on_end("train")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, num_workers)
        cbks = CallbackList(_to_list(callbacks) or [])
        cbks.set_model(self)
        cbks.on_begin("eval")
        for m in self._metrics:
            m.reset()
        total_loss = 0.0
        n = 0
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            losses, _ = self.eval_batch(inputs, labels)
            total_loss += sum(losses)
            n += 1
            cbks.on_eval_batch_end(step, {"loss": losses})
            if num_samples is not None and n * batch_size >= num_samples:
                break
        res = {"loss": total_loss / max(1, n)}
        for m in self._metrics:
            res[m.name()] = m.accumulate()
        cbks.on_end("eval", res)
        return res

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # --- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        # as the JAX `set_state_dict`: names the network lacks, or lacks
        # in the file, are passed over; a shape mismatch raises
        self.network.load_state_dict(fload(path + ".pdparams",
                                           device=self.device),
                                     strict=False)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt",
                                                 device=self.device))

    def parameters(self, *a, **kw):
        return self.network.parameters(*a, **kw)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        trainable = sum(p.numel() for p in self.network.parameters()
                        if p.requires_grad)
        text = (f"Total params: {n_params:,}\n"
                f"Trainable params: {trainable:,}\n"
                f"Non-trainable params: {n_params - trainable:,}")
        print(text)
        return {"total_params": n_params, "trainable_params": trainable}

    @staticmethod
    def _len_or_none(loader):
        try:
            return len(loader)
        except Exception:
            return None

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                return [batch[0]], [batch[1]]
            return list(batch[:-1]), [batch[-1]]
        return [batch], []
