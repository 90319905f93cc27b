"""Training steps of the score network, in plain float32 PyTorch.

One step over a batch of window starts ``idx`` [rounds, rows] into frames
[T, C, H, W]: each row's window is frames idx..idx+w-1 as [H, W, w C]
(channel frame * C + c); per round, t ~ U(0, 1) [rows, 1, 1, 1] and then
eps ~ N(0, 1) shaped like the rows are drawn from the step's generator;
x_t = mu(t) x + sigma(t) eps; the loss is the mean of (net(x_t, t) - eps)^2
over every row and element of the step; the gradient is that mean's.
Then AdamW (decoupled weight decay p <- p (1 - lr wd), bias-corrected
moments, eps added to the root of the second moment) and one EMA per step,
e <- r e + (1 - r) p. Rows go through the network in blocks of ``block``,
their gradients summed, so the batch need not fit at once.
"""

from __future__ import annotations

import torch

from h100_bench.reference.net import ReferenceUNet, identity
from h100_bench.reference.sampling import mu, sigma


def gather(data: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    frames = idx[:, None] + torch.arange(w, device=idx.device)[None, :]
    x = data[frames]  # [B, w, C, H, W]
    b, _, c, h, wd = x.shape
    return x.permute(0, 3, 4, 1, 2).reshape(b, h, wd, w * c).float()


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train(model: dict, p0: dict, data: torch.Tensor, idxs: list, generators: list, opt: dict, *,
          window: int, cast=identity, block: int = 16, fault: str = "") -> dict:
    """Run ``len(idxs)`` steps from parameters ``p0`` (left untouched);
    ``generators[s]`` makes step s's draws. Returns the losses, each leaf's
    norm of the first step's gradient, and each leaf's norm of the change
    of the parameters and of the EMA after the last step. ``fault="half_batch"`` leaves out the second half of every
    round's rows (the mean taken over the rest): a planted fault."""
    lr, wd, eps_adam = float(opt["lr"]), float(opt["weight_decay"]), float(opt.get("eps", 1e-8))
    b1, b2 = (float(b) for b in opt["betas"])
    rate = float(opt["ema"])
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    ema = {k: v.detach().clone().float() for k, v in p0.items()}
    net = ReferenceUNet(model, p, cast)
    losses, grad1 = [], None
    for s, (idx, gen) in enumerate(zip(idxs, generators), start=1):
        rounds, rows = idx.shape
        draws = []
        for r in range(rounds):
            x = gather(data, idx[r], window)
            t = torch.rand((rows, 1, 1, 1), generator=gen, device=x.device)
            e = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
            keep = rows // 2 if fault == "half_batch" else rows
            draws.append((x[:keep], t[:keep], e[:keep]))
        count = sum(d[0].numel() for d in draws)
        total = 0.0
        for x, t, e in draws:
            for a in range(0, len(x), block):
                xb, tb, eb = x[a:a + block], t[a:a + block], e[a:a + block]
                xt = mu(tb).to(xb.device) * xb + sigma(tb).to(xb.device) * eb
                err = net(xt, tb.reshape(-1)).float() - eb
                part = (err**2).sum() / count
                part.backward()
                total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            if s == 1:
                grad1 = _norms({k: q.grad for k, q in p.items()})
            for k, q in p.items():
                g = q.grad
                q.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v2[k].sqrt() / (1.0 - b2**s) ** 0.5).add_(eps_adam)
                q.addcdiv_(m[k], denom, value=-lr / (1.0 - b1**s))
                q.grad = None
                ema[k].mul_(rate).add_(q.detach(), alpha=1.0 - rate)
    with torch.no_grad():
        change = _norms({k: p[k].detach() - p0[k].float() for k in p})
        ema_change = _norms({k: ema[k] - p0[k].float() for k in p})
    return {"losses": losses, "grad1": grad1, "change": change, "ema_change": ema_change}
