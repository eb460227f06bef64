"""The stage-1 training step in plain PyTorch: per micro-batch the summed
label-smoothed cross-entropy of the units plus 10 x (masked L1 + spectral
convergence) of the mel; the gradients of all micro-batches summed, divided
by the summed count of sentences, clipped to a global norm of 10; AdamW
(0.9, 0.98, eps 1e-8, decoupled weight decay 0.01) at the rate of a linear
warm-up and cosine decay by the count of updates taken before (0 at the
first)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import stage1


def rate(opt: dict, count: int) -> float:
    warmup = min(opt["warmup_updates"], max(opt["max_updates"] - 1, 1))
    decay = max(opt["max_updates"], opt["warmup_updates"] + 1) - warmup
    if count < warmup:
        return opt["lr"] * count / warmup
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))
    return opt["lr"] * ((1.0 - 1e-3) * cosine + 1e-3)


def loss_fn(out: dict, micro: dict, pad: int, eps: float, mel_weight: float):
    """(loss, sentences): fairseq's label-smoothed NLL summed over tokens,
    the mel loss summed over sentences."""
    logits, targets = out["unit_logits"], micro["unit_tokens"].long()
    t = min(logits.shape[1], targets.shape[1])
    logits, targets = logits[:, :t], targets[:, :t]
    lp = F.log_softmax(logits, -1)
    valid = targets != pad
    nll = torch.where(valid, -lp.gather(-1, targets[..., None])[..., 0], 0.0).sum()
    smooth = torch.where(valid, -lp.sum(-1), 0.0).sum()
    eps_i = eps / (logits.shape[-1] - 1)
    ce = (1.0 - eps - eps_i) * nll + eps_i * smooth
    mel_mask = torch.repeat_interleave(micro["frames_mask"], 4, dim=1)
    pred, target = out["mel"], micro["mel"]
    t = min(pred.shape[1], target.shape[1], mel_mask.shape[1])
    pred, target, m = pred[:, :t], target[:, :t], mel_mask[:, :t].to(pred.dtype)
    l1 = ((pred - target).abs().mean(-1) * m).sum(1) / m.sum(1).clamp(min=1.0)
    diff = ((pred - target).square().sum(-1) * m).sum(1)
    some = diff > 0
    sc = torch.where(some, torch.where(some, diff, 1.0).sqrt(), 0.0)
    sc = sc / (target.square().sum(-1) * m).sum(1).sqrt().clamp(min=1e-8)
    return ce + mel_weight * (l1.sum() + sc.sum()), valid.any(dim=1).sum()


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def run_steps(P0: dict, arch: dict, opt: dict, batches: list, seed: int, device,
              start: int = 0) -> dict:
    """Updates from the state dict P0 (f32, on `device`), one a batch of
    host arrays shaped (accum, B, ...), with the dropout drawn from
    generators seeded with `seed`, the first at the rate of `start` updates
    taken. Returns each update's summed loss, each leaf's norm of the first
    update's gradient (divided and clipped), and each leaf's norm of its
    change over all the updates."""
    params = {n: t.detach().clone().requires_grad_() for n, t in P0.items() if not is_buffer(n)}
    P = {**{n: t for n, t in P0.items() if is_buffer(n)}, **params}
    noise = stage1.Noise(torch.Generator(device=device).manual_seed(seed),
                         torch.Generator().manual_seed(seed))
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = opt["adam_b1"], opt["adam_b2"]
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        sentences, loss_sum = torch.zeros((), device=device), 0.0
        for i in range(batch["video"].shape[0]):
            micro = {k: torch.as_tensor(a[i], device=device) for k, a in batch.items()}
            out = stage1.forward(P, arch, micro["video"], micro["frames_mask"], micro["spk_emb"],
                                 noise)
            loss, n = loss_fn(out, micro, arch["pad"], opt["label_smoothing"], opt["mel_weight"])
            names = list(params)
            for name, g in zip(names, torch.autograd.grad(loss, [params[k] for k in names],
                                                          allow_unused=True)):
                if g is not None:
                    grads[name] += g
            sentences = sentences + n
            loss_sum += float(loss.detach())
            del out, loss
        losses.append(loss_sum)
        with torch.no_grad():
            for g in grads.values():
                g /= sentences.clamp(min=1.0)
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            clip = 1.0 if float(norm) < opt["clip_norm"] else opt["clip_norm"] / norm
            for g in grads.values():
                g *= clip
            if step == 0:
                grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            lr, t = rate(opt, start + step), step + 1
            for n, p in params.items():
                g = grads[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * opt["weight_decay"])
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["adam_eps"])
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        del grads
    with torch.no_grad():
        deltas = {n: float((p - P0[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": deltas}
