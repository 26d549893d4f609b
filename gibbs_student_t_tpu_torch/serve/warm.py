"""Variational warm starts for served tenants (arXiv:2405.08857).

Counterpart of ``gibbs_student_t_tpu/serve/warm.py``. In serving, burn-in
is a tenant's latency: chains started from prior draws spend their first
rows in an overdispersed transient, which wastes sweeps and, worse for
``on_converged="evict"``, keeps the streaming monitor's early windows
reading a high autocorrelation time, so the eviction verdict lands quanta
after the chains mixed.

A :class:`WarmStartFit` replaces the prior-draw init with draws from a
moment-matched Gaussian mixture fitted to a short pilot run of the
tenant's own model (a few chains, a few dozen sweeps): one component per
pilot chain, so chains that found different modes stay different
components. ``kind="flow"`` (:class:`FlowWarmStartFit`) trains a small
masked-affine flow on the pooled pilot rows instead, the recipe of the
paper proper; :data:`FIT_KINDS` maps each kind to its class.

Determinism and recovery: a fit is summarized as small JSON arrays and
journaled in the tenant's manifest admit record (serve/manifest.py), and
the init draw is a numpy stream seeded from the request seed, in pure
float64 numpy on both fit kinds. So :meth:`ChainServer.recover` replays a
warm-started tenant's init without re-running the pilot, and a fit
journaled by either this package or the JAX package draws the same x0,
bit for bit, in both.

Failure contract: a warm start is an optimization, never a correctness
dependency. A failed pilot or fit warns, emits ``warm_start_degraded`` and
serves the tenant from the cold prior init; a failed flow fit falls back
to the mixture (the tenant stays warm) and emits ``warm_flow_degraded``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from gibbs_student_t_tpu_torch.models.parameter import KIND_NORMAL
from gibbs_student_t_tpu_torch.utils.env import env_choice


def warm_flow_env() -> str:
    """The validated ``GST_WARM_FLOW`` (``auto`` when unset), strictly
    ``auto|1|0``: ``auto`` honours each spec's ``kind``, ``1`` makes every
    pilot fit the flow, ``0`` makes flow requests fit the mixture (the
    tenant stays warm; a ``warm_flow_degraded`` event names the
    downgrade)."""
    return env_choice("GST_WARM_FLOW")


def resolve_fit_kind(requested: str, env: Optional[str] = None) -> str:
    """The fit family of a pilot under ``GST_WARM_FLOW``: ``0`` -> ``gmm``,
    ``1`` -> ``flow``, ``auto`` -> the spec's own ``kind``."""
    env = env if env is not None else warm_flow_env()
    if env == "0":
        return "gmm"
    if env == "1":
        return "flow"
    return requested


def warm_start_env() -> str:
    """The validated ``GST_WARM_START`` (``auto`` when unset), strictly
    ``auto|1|0``: ``auto`` honours each request's ``warm_start`` (no
    request, no pilot); ``1`` warm-starts every tenant without one with
    the default spec; ``0`` turns the arm off: every tenant starts from
    the cold prior init, bitwise today's (requests degrade with an
    event)."""
    return env_choice("GST_WARM_START")


@dataclass
class WarmStartSpec:
    """A tenant's warm-start request (``TenantRequest.warm_start``).

    ``pilot_sweeps`` x ``pilot_chains`` bounds the pilot's work;
    ``burn_frac`` drops the pilot's own transient before the fit;
    ``jitter_frac`` floors each component's per-parameter std at that
    fraction of the prior's scale, so a stuck pilot column never collapses
    a component to a point. ``kind`` is the fit family, ``"gmm"`` or
    ``"flow"`` (``GST_WARM_FLOW`` can force either; a failed flow fit
    falls back to the mixture)."""

    pilot_sweeps: int = 64
    pilot_chains: int = 8
    burn_frac: float = 0.5
    jitter_frac: float = 0.02
    kind: str = "gmm"

    def __post_init__(self):
        if self.kind not in ("gmm", "flow"):
            raise ValueError(
                f"warm-start kind must be 'gmm' or 'flow', got "
                f"{self.kind!r}")
        if self.pilot_sweeps < 8:
            raise ValueError(f"pilot_sweeps must be >= 8, got "
                             f"{self.pilot_sweeps}")
        if self.pilot_chains < 1:
            raise ValueError(f"pilot_chains must be >= 1, got "
                             f"{self.pilot_chains}")
        if not 0.0 <= self.burn_frac < 1.0:
            raise ValueError(f"burn_frac must be in [0, 1), got "
                             f"{self.burn_frac}")
        if self.jitter_frac < 0.0:
            raise ValueError(f"jitter_frac must be >= 0, got "
                             f"{self.jitter_frac}")


@dataclass
class WarmStartFit:
    """A fitted init distribution: ``K`` diagonal-Gaussian components over
    the sampled parameter vector, and what recovery replays from. ``kind``
    names the family in :data:`FIT_KINDS`."""

    means: np.ndarray            # (K, p)
    stds: np.ndarray             # (K, p)
    weights: np.ndarray          # (K,)
    kind: str = "gmm"
    pilot_sweeps: int = 0
    pilot_chains: int = 0
    pilot_ms: float = 0.0
    meta: Dict = field(default_factory=dict)

    def draw_x0(self, nchains: int, seed: int,
                specs: np.ndarray) -> np.ndarray:
        """``(nchains, p)`` init draws from the mixture, clipped into the
        prior's support (an x0 outside it has a -inf prior, and the MH
        blocks could never leave it). Deterministic in ``seed``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0x57A7]))
        k = rng.choice(len(self.weights), size=nchains,
                       p=np.asarray(self.weights, np.float64)
                       / np.sum(self.weights))
        x = (np.asarray(self.means, np.float64)[k]
             + np.asarray(self.stds, np.float64)[k]
             * rng.standard_normal((nchains, self.means.shape[1])))
        return clip_to_support(x, specs)

    def to_json(self) -> Dict:
        return {
            "kind": self.kind,
            "means": np.asarray(self.means, np.float64).tolist(),
            "stds": np.asarray(self.stds, np.float64).tolist(),
            "weights": np.asarray(self.weights, np.float64).tolist(),
            "pilot_sweeps": int(self.pilot_sweeps),
            "pilot_chains": int(self.pilot_chains),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "WarmStartFit":
        kind = d.get("kind", "gmm")
        if kind not in FIT_KINDS:
            raise ValueError(
                f"unknown warm-start fit kind {kind!r} "
                f"(known: {sorted(FIT_KINDS)})")
        tgt = FIT_KINDS[kind]
        if tgt is not cls:
            # a journaled flow record rebuilds the flow class through the
            # base entry point too (the path recover() takes)
            return tgt.from_json(d)
        return cls(means=np.asarray(d["means"], np.float64),
                   stds=np.asarray(d["stds"], np.float64),
                   weights=np.asarray(d["weights"], np.float64),
                   kind=kind,
                   pilot_sweeps=int(d.get("pilot_sweeps", 0)),
                   pilot_chains=int(d.get("pilot_chains", 0)))


#: fit family -> the class that rebuilds it from its journaled JSON
FIT_KINDS: Dict[str, type] = {"gmm": WarmStartFit}


@dataclass
class FlowWarmStartFit(WarmStartFit):
    """``kind="flow"``: a small masked-affine (RealNVP-style) flow trained
    on the pooled post-burn pilot rows, on the mixture's journal, draw and
    replay plumbing.

    ``means`` and ``stds`` hold the ``(1, p)`` pooled standardization
    (``weights == [1.0]``); ``flow`` holds the coupling layers' parameters
    as float64 JSON lists. :meth:`draw_x0` is pure float64 numpy over the
    journaled parameters (base normals, the coupling layers, the
    de-standardization, :func:`clip_to_support`), so a replay needs
    neither the pilot nor the training, and draws the same x0 as the JAX
    package from the same record."""

    #: {"hidden": H, "layers": [{"mask", "W1", "b1", "W2", "b2"}, ...]}
    flow: Dict = field(default_factory=dict)
    kind: str = "flow"

    def _forward_np(self, z: np.ndarray) -> np.ndarray:
        """Base normals ``(n, p)`` -> standardized flow samples, in
        float64 numpy (the replay side)."""
        x = np.asarray(z, np.float64)
        p = x.shape[1]
        for lyr in self.flow["layers"]:
            m = np.asarray(lyr["mask"], np.float64)
            w1 = np.asarray(lyr["W1"], np.float64)
            b1 = np.asarray(lyr["b1"], np.float64)
            w2 = np.asarray(lyr["W2"], np.float64)
            b2 = np.asarray(lyr["b2"], np.float64)
            hid = np.tanh((x * m) @ w1 + b1)
            st = hid @ w2 + b2
            s = np.tanh(st[:, :p]) * (1.0 - m)
            t = st[:, p:] * (1.0 - m)
            x = m * x + (1.0 - m) * (x * np.exp(s) + t)
        return x

    def draw_x0(self, nchains: int, seed: int,
                specs: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0x57A7]))
        z = rng.standard_normal((nchains, self.means.shape[1]))
        x = (np.asarray(self.means, np.float64)[0]
             + np.asarray(self.stds, np.float64)[0]
             * self._forward_np(z))
        return clip_to_support(x, specs)

    def to_json(self) -> Dict:
        d = super().to_json()
        d["flow"] = self.flow
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "FlowWarmStartFit":
        fl = d.get("flow")
        if not fl or not fl.get("layers"):
            raise ValueError("flow fit record missing 'flow' payload")
        return cls(means=np.asarray(d["means"], np.float64),
                   stds=np.asarray(d["stds"], np.float64),
                   weights=np.asarray(d["weights"], np.float64),
                   kind="flow",
                   pilot_sweeps=int(d.get("pilot_sweeps", 0)),
                   pilot_chains=int(d.get("pilot_chains", 0)),
                   flow=fl)

    @classmethod
    def fit(cls, post: np.ndarray, gmm: WarmStartFit,
            spec: "WarmStartSpec", pilot_ms: float = 0.0,
            hidden: int = 16, steps: int = 300,
            lr: float = 5e-3) -> "FlowWarmStartFit":
        """Train the flow on the pooled post-burn rows ``(rows, chains,
        p)``: 2 coupling layers, full-batch Adam for ``steps`` steps,
        torch autograd in float32. The standardization's stds are floored
        by the fitted mixture's per-parameter floors; the first layer's
        weights are drawn from a ``torch.Generator`` seeded with 0 and the
        output layers are zero, so training starts at the identity (the
        pooled-Gaussian fit).

        It runs on the CPU on every machine, by design: this is host work
        like the monitor's FFT, at most ``pilot_chains x pilot_sweeps / 2``
        rows of ``p`` values, and a device would add only launch and copy
        latency. Its trained parameters are this package's own (they
        differ from the JAX fit's); what both packages share is the
        journal and the replay. Raises on non-finite training; the caller
        falls back to the mixture."""
        import torch

        data = np.asarray(post, np.float64).reshape(-1, post.shape[-1])
        n, p = data.shape
        if n < 8:
            raise ValueError(
                f"flow fit needs >= 8 pooled pilot rows, got {n}")
        mu = data.mean(axis=0)
        sd = np.maximum(data.std(axis=0, ddof=1),
                        np.asarray(gmm.stds, np.float64).min(axis=0))
        zdata = torch.as_tensor((data - mu) / sd, dtype=torch.float32)

        nlayers = 2
        masks = [torch.as_tensor(np.arange(p) % 2 == (layer % 2),
                                 dtype=torch.float32)
                 for layer in range(nlayers)]
        gen = torch.Generator().manual_seed(0)
        params = []
        for _ in range(nlayers):
            # zero W2 and b2: s = t = 0, the identity
            params.append([
                (0.05 * torch.randn((p, hidden), generator=gen)),
                torch.zeros(hidden), torch.zeros((hidden, 2 * p)),
                torch.zeros(2 * p)])
        leaves = [a.requires_grad_() for ps in params for a in ps]

        def nll():
            x = zdata
            ld = torch.zeros(x.shape[0])
            for m, (w1, b1, w2, b2) in zip(reversed(masks),
                                           reversed(params)):
                hid = torch.tanh((x * m) @ w1 + b1)
                st = hid @ w2 + b2
                s = torch.tanh(st[:, :p]) * (1.0 - m)
                t = st[:, p:] * (1.0 - m)
                x = m * x + (1.0 - m) * ((x - t) * torch.exp(-s))
                ld = ld - s.sum(dim=1)
            return torch.mean(0.5 * torch.sum(x * x, dim=1) - ld)

        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        final = float("nan")
        for _ in range(steps):
            opt.zero_grad()
            loss = nll()
            loss.backward()
            opt.step()
            final = float(loss.detach())
        if not np.isfinite(final):
            raise ValueError(f"flow training diverged (nll={final})")
        layers = []
        for m, ps in zip(masks, params):
            arrs = [np.asarray(a.detach().numpy(), np.float64)
                    for a in [m] + ps]
            if not all(np.isfinite(a).all() for a in arrs):
                raise ValueError("flow training produced non-finite "
                                 "parameters")
            layers.append(dict(zip(
                ("mask", "W1", "b1", "W2", "b2"),
                (a.tolist() for a in arrs))))
        return cls(
            means=mu[None, :], stds=sd[None, :],
            weights=np.ones(1), kind="flow",
            pilot_sweeps=gmm.pilot_sweeps,
            pilot_chains=gmm.pilot_chains, pilot_ms=pilot_ms,
            flow={"hidden": int(hidden), "layers": layers},
            meta={"nll": final, "steps": int(steps)})


FIT_KINDS["flow"] = FlowWarmStartFit


def clip_to_support(x: np.ndarray, specs: np.ndarray) -> np.ndarray:
    """Clip ``(..., p)`` parameter draws into each prior's support, 1e-3
    of the width inside the bounds of the bounded kinds (Uniform and
    LinearExp carry [a, b]; Normal is unbounded)."""
    specs = np.asarray(specs, np.float64)
    kind = specs[:, 0].astype(int)
    a, b = specs[:, 1], specs[:, 2]
    bounded = kind != KIND_NORMAL
    inset = 1e-3 * (b - a)
    lo = np.where(bounded, a + inset, -np.inf)
    hi = np.where(bounded, b - inset, np.inf)
    return np.clip(np.asarray(x, np.float64), lo, hi)


def fit_from_rows(rows: np.ndarray, spec: WarmStartSpec,
                  prior_specs: np.ndarray,
                  pilot_ms: float = 0.0) -> WarmStartFit:
    """Fit from pilot x rows ``(rows, chains, p)``: the leading
    ``burn_frac`` rows are dropped and each chain's rest becomes one
    diagonal-Gaussian component of uniform weight (or, for a flow spec,
    the flow is trained on them). Shared by both pilots (in the pool and
    standalone), so the fit cannot drift between them."""
    rows = np.asarray(rows, np.float64)
    burn = int(spec.burn_frac * rows.shape[0])
    post = rows[burn:]
    if post.shape[0] < 2:
        raise ValueError(
            f"pilot leaves {post.shape[0]} post-burn rows; need >= 2")
    means = post.mean(axis=0).astype(np.float64)       # (K, p)
    stds = post.std(axis=0, ddof=1).astype(np.float64)
    # per-parameter std floor: jitter_frac of the prior's scale (bounded
    # kinds: the support's width; Normal: sigma)
    specs = np.asarray(prior_specs, np.float64)
    kind = specs[:, 0].astype(int)
    scale = np.where(kind == KIND_NORMAL, specs[:, 2],
                     specs[:, 2] - specs[:, 1])
    stds = np.maximum(stds, spec.jitter_frac * np.abs(scale))
    K = means.shape[0]
    gmm = WarmStartFit(
        means=means, stds=stds,
        weights=np.full(K, 1.0 / K),
        pilot_sweeps=rows.shape[0],
        pilot_chains=means.shape[0],
        pilot_ms=pilot_ms)
    eff = resolve_fit_kind(spec.kind)
    if eff != "flow":
        if spec.kind == "flow":
            # GST_WARM_FLOW=0: still warm (the mixture), never cold; the
            # server names the downgrade (warm_flow_degraded)
            gmm.meta["flow_degraded"] = "GST_WARM_FLOW=0"
        return gmm
    try:
        return FlowWarmStartFit.fit(post, gmm, spec, pilot_ms=pilot_ms)
    except Exception as e:  # noqa: BLE001 - warm, not cold
        warnings.warn(f"flow warm-start fit failed "
                      f"({type(e).__name__}: {e}); degrading to the "
                      f"moment-matched mixture", RuntimeWarning)
        gmm.meta["flow_degraded"] = f"{type(e).__name__}: {e}"
        return gmm


def fit_warm_start(ma, config, spec: WarmStartSpec, seed: int,
                   device=None) -> WarmStartFit:
    """The standalone pilot: a ``pilot_chains``-chain ``TorchGibbs`` on
    ``device`` samples ``pilot_sweeps`` sweeps of the tenant's model in
    ``record="light"`` mode, and :func:`fit_from_rows` fits it.

    The serial executor uses it (its staging runs on the driving thread,
    so a pilot served by the pool would wait on itself); the pipelined
    executor serves pilots on the pool (``ChainServer._pool_pilot_fit``),
    where they ride the pool's lanes kernels with every other tenant."""
    from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs

    t0 = time.monotonic()
    pb = TorchGibbs(ma, config, nchains=spec.pilot_chains, device=device,
                    chunk_size=spec.pilot_sweeps, record="light",
                    tnt_block_size=None, telemetry=False)
    res = pb.sample(niter=spec.pilot_sweeps, seed=seed)
    return fit_from_rows(np.asarray(res.chain), spec, ma.specs_np,
                         pilot_ms=(time.monotonic() - t0) * 1e3)


def resolve_warm_start(request_warm, env: Optional[str] = None):
    """The tenant's warm-start input under ``GST_WARM_START``: ``None``
    (cold), a :class:`WarmStartSpec` (fit at staging) or a
    :class:`WarmStartFit` (journaled: a replay). ``0`` disables every
    request; ``1`` gives every tenant without one ``WarmStartSpec()``."""
    env = env if env is not None else warm_start_env()
    if env == "0":
        return None
    if request_warm is None:
        return WarmStartSpec() if env == "1" else None
    if isinstance(request_warm, (WarmStartSpec, WarmStartFit)):
        return request_warm
    if isinstance(request_warm, dict):
        return WarmStartFit.from_json(request_warm)
    raise ValueError(
        f"warm_start must be a WarmStartSpec, a WarmStartFit (or its "
        f"JSON dict), or None, got {type(request_warm).__name__}")
