#!/usr/bin/env python3
"""`Model.fit`'s step against the eager O2 loop's, on one card.

    python3 tools_torch/fit_split.py

GPT-125M (bench.py's widths, 12 layers, no fused head), bf16 O2, AdamW,
B8 x 1024, six steps a run, tokens/s over steps 3-6, in turns in one
process: the eager loop, `fit` without a metric (no workers), `fit`
with `metric.Accuracy` (no workers, then two shared-memory workers),
the eager loop again.  Then torch.profiler over the fourth step of a
`fit` with Accuracy and of the eager loop: device ms and the top ops by
host and by device time.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from paddle_tpu_torch import Model, amp, metric, nn
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    card, _ = CS.phase_device()
    _build.build(["flash_fwd", "flash_bwd"])
    B, S, N = 8, 1024, 6
    cfg = CS._hapi_cfg()
    x, y = CS._hapi_tokens(cfg, B * N, S, 0)

    class Times(Callback):
        def __init__(self, prof_step=None):
            super().__init__()
            self.t, self.prof_step, self.prof = [], prof_step, None

        def on_train_batch_begin(self, step, logs=None):
            if step == self.prof_step:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()

        def on_train_batch_end(self, step, logs=None):
            if step == self.prof_step:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
            self.t.append(time.perf_counter())

    def fit(metrics, workers, prof_step=None):
        net, _ = CS._hapi_gpt(0)
        m = Model(net)
        m.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), metric.Accuracy() if metrics else None,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
        rec = Times(prof_step)
        loader = DataLoader(TensorDataset([x, y]), batch_size=B,
                            num_workers=workers)
        m.fit(loader, callbacks=[rec])
        del m, net
        CS._release_card()
        return B * S * (N - 2) / (rec.t[-1] - rec.t[1]), rec.prof

    def eager(prof_step=None):
        net, _ = CS._hapi_gpt(0)
        opt = AdamW(learning_rate=1e-4, parameters=net.parameters())
        net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
        net.train()
        crit = nn.CrossEntropyLoss()
        t, prof = [], None
        for i in range(N):
            if i == prof_step:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            ids = torch.from_numpy(x[i * B:(i + 1) * B]).cuda()
            lab = torch.from_numpy(y[i * B:(i + 1) * B]).cuda()
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = crit(net(ids), lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            float(loss)
            if i == prof_step:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            t.append(time.perf_counter())
        del net, opt
        CS._release_card()
        return B * S * (N - 2) / (t[-1] - t[1]), prof

    rows = [("eager", eager()[0]), ("fit, no metric, 0 workers",
                                    fit(False, 0)[0]),
            ("fit, Accuracy, 0 workers", fit(True, 0)[0]),
            ("fit, Accuracy, 2 shm workers", fit(True, 2)[0]),
            ("eager", eager()[0])]
    for what, tps in rows:
        CS.log(f"[fit_profile] {what} ({card}): {tps:.1f} tokens/s")
    for what, prof in (("fit step", fit(True, 0, prof_step=3)[1]),
                       ("eager step", eager(prof_step=3)[1])):
        ka = prof.key_averages()
        dev = sum(e.self_device_time_total for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA)
        CS.log(f"[fit_profile] {what}: device {dev / 1e3:.3f} ms")
        CS.log(ka.table(sort_by="self_cpu_time_total", row_limit=18,
                        max_name_column_width=60))
        CS.log(ka.table(sort_by="self_cuda_time_total", row_limit=12,
                        max_name_column_width=60))


if __name__ == "__main__":
    main()
