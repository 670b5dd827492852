"""Plain reference of federated GPT-2 rounds, in f32 with TF32 off.

The model is GPT-2 as the port configures it (``configs/gpt2-large.json``:
its ``port`` group and ``departures``): token embedding, per layer an
RMSNorm, multi-head causal attention with RoPE (the two halves of each
head rotated), an RMSNorm and a tanh-GELU MLP, each added to the residual
stream; a final RMSNorm and the head (the embedding's transpose where
the configuration ties it); no biases; the mean next-token
cross-entropy. Written from that description in whole-tensor torch ops
and autograd, every product in f32; nothing of the program is imported.

A round follows the benchmark's round body: each client starts from the
global parameters, takes the mix's local steps of SGD with momentum
(``v ← μ·v + g; p ← p − η·v``, from v = 0), and uploads ``global −
local``; the mean of the uploads (an f32 left fold in client order, one
IEEE divide by N) is subtracted from the global parameters. Each step's
batch is taken in row blocks (``ref_block_rows``), the loss of a block
being its summed token losses over the whole batch's token count, so that
the activations of a full-width model fit beside its state.

``lower=True`` is the control: every matrix product of the model's
projections and head (bf16 in the program) takes its operands rounded to
fp8 (e4m3, one scale a tensor) in the forward pass. ``fault`` plants one
of the faults the check must catch: ``"unchanged"`` (a local step leaves
the parameters as they were), ``"half_batch"`` (the loss over the first
half of the batch's rows only) or ``"altered"`` (one element of the
round's mean set to 1.0).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench import inputs

NEG = -1e30


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x with its value rounded to e4m3 at one scale (448 at its largest
    magnitude); the gradient passes through unchanged."""
    xd = x.detach()
    scale = xd.abs().amax().clamp(min=1e-30) / 448.0
    q = (xd / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - xd)


def _mm(lower: bool):
    if not lower:
        return torch.matmul
    return lambda a, b: torch.matmul(_fp8(a), _fp8(b))


def _rms(x, gamma, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * gamma


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def block_loss(p: dict, cfg: dict, tokens, labels, total: int,
               lower: bool = False) -> torch.Tensor:
    """The summed next-token losses of a block of rows, over ``total``."""
    port = cfg["port"]
    d, h = cfg["n_embd"], cfg["n_head"]
    hd, eps = d // h, cfg["layer_norm_epsilon"]
    mm = _mm(lower)
    b, s = tokens.shape
    dev = tokens.device
    freqs = 1.0 / (port["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=dev)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    causal = torch.full((s, s), NEG, device=dev).triu(1)
    layers = {k[len("layers."):]: p[k].unbind(0) for k in p
              if k.startswith("layers.")}
    x = p["embed"][tokens]
    for i in range(cfg["n_layer"]):
        a = _rms(x, layers["ln1"][i], eps)
        q, k, v = (mm(a, layers[f"attn.{w}"][i].reshape(d, d))
                   .view(b, s, h, hd) for w in ("wq", "wk", "wv"))
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores + causal, dim=-1)
        o = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, d)
        x = x + mm(o, layers["attn.wo"][i].reshape(d, d))
        m = _rms(x, layers["ln2"][i], eps)
        m = F.gelu(mm(m, layers["mlp.w1"][i]), approximate="tanh")
        x = x + mm(m, layers["mlp.w2"][i])
    head = p["embed"].T if cfg["tie_word_embeddings"] else p["lm_head"]
    logits = mm(_rms(x, p["final_norm"], eps), head)
    nll = torch.logsumexp(logits, dim=-1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll.sum() / total


def loss_and_grads(p: dict, cfg: dict, mix: dict, batch: dict,
                   lower: bool = False, half: bool = False):
    """The batch's mean token loss and every leaf's gradient."""
    toks, labels = batch["tokens"], batch["labels"]
    if half:
        toks, labels = toks[: toks.shape[0] // 2], labels[: labels.shape[0]
                                                          // 2]
    rows = int(toks.shape[0])
    step = int(mix.get("ref_block_rows", rows))
    leaves = {k: v.requires_grad_(True) for k, v in p.items()}
    total, loss = rows * int(toks.shape[1]), 0.0
    for lo in range(0, rows, step):
        part = block_loss(leaves, cfg, toks[lo:lo + step],
                          labels[lo:lo + step], total, lower)
        part.backward()
        loss += float(part.detach())
    grads = {}
    for k, v in leaves.items():
        grads[k] = v.grad
        v.grad = None
        v.requires_grad_(False)
    return loss, grads


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def follow(cfg: dict, mix: dict, seed: int, device: str, rounds: int, *,
           lower: bool = False, fault: str | None = None) -> dict:
    """The first ``rounds`` rounds from the seed's parameters and batches:
    every local step's loss ``losses[r][c][s]``, the per-leaf norms of the
    first gradient (round 0, client 0, step 0) ``grad_norms``, and of the
    parameters' change after the rounds ``change_norms``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = inputs.gpt2_params(cfg, seed, device)
    init = {k: v.clone() for k, v in params.items()}
    data = inputs.ZipfTokens(cfg, mix, seed, device)
    lr, mu = float(mix["lr"]), float(mix["momentum"])
    n = mix["clients"]
    losses, grad_norms = [], None
    for r in range(rounds):
        acc, per_client = None, []
        for c in range(n):
            local = {k: v.clone() for k, v in params.items()}
            vel = {k: torch.zeros_like(v) for k, v in params.items()}
            steps = []
            for s in range(mix["local_steps"]):
                loss, grads = loss_and_grads(
                    local, cfg, mix, data.batch_of(r, c, s), lower,
                    half=fault == "half_batch")
                steps.append(loss)
                if grad_norms is None:
                    grad_norms = leaf_norms(grads)
                if fault == "unchanged":
                    continue
                with torch.no_grad():
                    for k in local:
                        vel[k].mul_(mu).add_(grads[k])
                        local[k].sub_(vel[k] * lr)
                del grads
            per_client.append(steps)
            with torch.no_grad():
                delta = {k: params[k] - local[k] for k in params}
                if acc is None:
                    acc = delta
                else:
                    for k in acc:
                        acc[k].add_(delta[k])
            del local, vel, delta
        losses.append(per_client)
        with torch.no_grad():
            for k in acc:
                acc[k].div_(_f32(float(n), acc[k].device))
            if fault == "altered":
                first = sorted(acc)[0]
                acc[first].view(-1)[0] = 1.0
            params = {k: params[k] - acc[k] for k in params}
        del acc
    change = {k: params[k] - init[k] for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": leaf_norms(change)}


def leaf_norms(tree: dict) -> dict:
    """Each leaf's 2-norm, accumulated in f64."""
    return {k: float(torch.linalg.vector_norm(v.detach(), dtype=torch.float64))
            for k, v in tree.items()}


def gaps(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between two norms: ``|got − want|`` over the
    larger of the reference's norm of that leaf and of the median leaf;
    ``keep`` (a set of leaf names) limits the leaves compared."""
    names = sorted(want if keep is None else keep)
    vals = sorted(want[k] for k in names)
    if not vals:
        return math.inf
    median = vals[len(vals) // 2]
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30)
               for k in names)
