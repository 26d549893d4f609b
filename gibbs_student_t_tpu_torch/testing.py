"""Float64 replays that keep an MH block's decisions clear of float32 ties.

A float32 Metropolis decision within roundoff of its threshold can go
either way between two correct implementations (a kernel and its plain
version, the card and the CPU). These helpers replay a block in float64
and move every draw that lies within ``margin`` of its decision to
``push`` beyond it, on the side of the decision already taken, so the
float64 path is unchanged and every float32 implementation that is right
to within ``margin`` takes the same decisions. The tests and
``chip_smoke.py`` use them; the sampler does not.
"""

from __future__ import annotations

import torch

#: a step's margin, in multiples of the largest departure of a float32
#: evaluation from the float64 delta (see :func:`separate_ties`)
SPREAD_FACTOR = 4.0


def separate_ties(ll_lp64, x, dx, logu, margin=1e-3, push=1e-2, others=(),
                  info=None):
    """Single-try block: ``ll_lp64(q (C, p)) -> (ll, lp)`` in float64,
    ``dx (C, S, p)``, ``logu (C, S)``. Returns the adjusted ``logu``
    (float32) where every ``|delta - logu| >= margin``.

    ``others`` are float32 evaluations ``ll_lp(q) -> (ll, lp)`` of the
    same block (on other operands or another device; ``q`` is passed as
    float32 on ``x``'s device). They follow the float64 path's decisions
    with float32 arithmetic, as a float32 block forms its proposals
    (``x + dx`` rounded in float32), so a proposal that float32 rounds
    onto a prior bound, or off it, is seen. Where a step's float32 delta
    departs from the float64 one by ``err``, that step's margin grows to
    ``SPREAD_FACTOR * err`` and its push to twice its margin: a decision
    that float32 cannot resolve is moved out of its reach. Where one of
    them is not finite and the float64 delta is, or the other way round,
    ``logu`` is set to -inf (float64 accepts) or +inf (it rejects). A
    dict passed as ``info`` receives ``max_err``, the largest finite
    ``err``, and ``forced``, the number of draws set to an infinity."""
    xf, dxf = x.float(), dx.float()
    x = x.double()
    dx = dx.double()
    logu = logu.clone().double()

    def evals(q, qf):
        out = [ll_lp64(q)]
        for f in others:
            ll, lp = f(qf)
            out.append((ll.to(x.device, torch.float64),
                        lp.to(x.device, torch.float64)))
        return [ll + lp for ll, lp in out]

    w0 = evals(x, xf)
    max_err, forced = 0.0, 0
    for i in range(dx.shape[1]):
        q = x + dx[:, i]
        qf = xf + dxf[:, i]
        w1 = evals(q, qf)
        delta = w1[0] - w0[0]
        err = torch.zeros_like(delta)
        force = torch.zeros_like(delta, dtype=torch.bool)
        for a, b in zip(w1[1:], w0[1:]):
            d = a - b
            both = torch.isfinite(d) & torch.isfinite(delta)
            err = torch.maximum(err, torch.where(both, (d - delta).abs(), 0.0))
            force |= ~both & (d != delta)
        max_err = max(max_err, float(err.max()))
        mg = torch.clamp(SPREAD_FACTOR * err, min=margin)
        ps = torch.maximum(torch.full_like(mg, push), 2.0 * mg)
        acc = delta > logu[:, i]
        near = (delta - logu[:, i]).abs() < mg
        lu = torch.where(near & acc, delta - ps,
                         torch.where(near, delta + ps, logu[:, i]))
        inf = torch.full_like(lu, float("inf"))
        logu[:, i] = torch.where(force, torch.where(acc, -inf, inf), lu)
        forced += int(force.sum())
        x = torch.where(acc[:, None], q, x)
        xf = torch.where(acc[:, None], qf, xf)
        w0 = [torch.where(acc, a, b) for a, b in zip(w1, w0)]
    if info is not None:
        info.update(max_err=max_err, forced=forced)
    return logu.float()


def separate_mtm_ties(weight64, x, dx, dxr, gumb, logu, margin=1e-3,
                      push=1e-2):
    """Multiple-try block (``ops.white_mh.mtm_loop``): ``weight64(q (C, J,
    p)) -> (C, J)`` log weights in float64, draws as ``mtm_loop`` takes
    them. Where the best two Gumbel scores of a step lie within ``margin``,
    the winner's Gumbel draw moves up by ``push``; where the accept delta
    lies within ``margin`` of ``logu``, ``logu`` moves as in
    :func:`separate_ties`. Returns the adjusted ``(gumb, logu)``
    (float32)."""
    x = x.double()
    dx, dxr = dx.double(), dxr.double()
    gumb = gumb.clone().double()
    logu = logu.clone().double()
    p = x.shape[-1]
    wx = weight64(x[:, None])[:, 0]
    for i in range(dx.shape[1]):
        cands = x[:, None] + dx[:, i]
        lw = weight64(cands)
        score = lw + gumb[:, i]
        top2 = torch.topk(score, 2, dim=-1).values
        j = torch.argmax(score, dim=-1, keepdim=True)
        close = (top2[:, 0] - top2[:, 1] < margin) & torch.isfinite(top2[:, 0])
        gumb[:, i].scatter_add_(1, j, (close.double() * push)[:, None])
        y = torch.gather(cands, 1, j[..., None].expand(-1, -1, p))[:, 0]
        lwy = torch.gather(lw, 1, j)[:, 0]
        lwr = torch.cat([weight64(y[:, None] + dxr[:, i]), wx[:, None]], -1)
        delta = torch.logsumexp(lw, -1) - torch.logsumexp(lwr, -1)
        acc = delta > logu[:, i]
        near = (delta - logu[:, i]).abs() < margin
        logu[:, i] = torch.where(near & acc, delta - push,
                                 torch.where(near, delta + push, logu[:, i]))
        x = torch.where(acc[:, None], y, x)
        wx = torch.where(acc, lwy, wx)
    return gumb.float(), logu.float()
