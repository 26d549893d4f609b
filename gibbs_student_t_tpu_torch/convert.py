"""Carry a model and a chain state across from the JAX package.

The port imports nothing of ``gibbs_student_t_tpu``, so the crossing is
made of plain data: a ``ModelArrays`` given as a dict of its fields,
whose ``phi_blocks`` are ``dataclasses.asdict``-style dicts, and a chain
state given as a dict (or any mapping) of numpy arrays. Tests use it to
feed both packages the same model and state::

    fields = {f.name: getattr(ma, f.name) for f in dataclasses.fields(ma)}
    fields["phi_blocks"] = [dataclasses.asdict(b) for b in ma.phi_blocks]
    ma_t = model_arrays_from_fields(fields)

A stacked ensemble model (``parallel.ensemble.stack_model_arrays`` of
either package, every data field with a leading pulsar axis) and an
ensemble state with leading ``(P, C)`` axes cross the same way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gibbs_student_t_tpu_torch.models.pta import (
    ConstBlock,
    EcorrBlock,
    ImproperBlock,
    ModelArrays,
    PowerlawBlock,
)


def _num(v):
    """A block's scalar data field as a float, or, stacked over pulsars,
    as an array."""
    return float(v) if np.ndim(v) == 0 else np.array(v)


def _phi_block(d: Mapping):
    """One frozen phi block from its field dict; the kind is read off the
    fields each block type alone carries."""
    if "freqs" in d:
        return PowerlawBlock(int(d["start"]), int(d["stop"]),
                             np.array(d["freqs"]), _num(d["df"]),
                             int(d["idx_log10A"]), _num(d["const_log10A"]),
                             int(d["idx_gamma"]), _num(d["const_gamma"]))
    if "col_group" in d:
        return EcorrBlock(int(d["start"]), int(d["stop"]),
                          tuple(int(g) for g in d["col_group"]),
                          tuple(int(i) for i in d["idx"]),
                          np.asarray(d["const"]))
    if "phi" in d:
        return ConstBlock(int(d["start"]), int(d["stop"]),
                          np.asarray(d["phi"]))
    if set(d) == {"start", "stop"}:
        return ImproperBlock(int(d["start"]), int(d["stop"]))
    raise ValueError(f"unrecognised phi block fields {sorted(d)}")


def model_arrays_from_fields(fields: Mapping) -> ModelArrays:
    """The port's ``ModelArrays`` from the JAX package's, given as plain
    data (see the module docstring). Arrays are copied, never shared."""
    row_mask = fields.get("row_mask")
    return ModelArrays(
        name=str(fields["name"]),
        y=np.array(fields["y"]),
        T=np.array(fields["T"]),
        sigma2=np.array(fields["sigma2"]),
        efac_masks=np.array(fields["efac_masks"]),
        efac_idx=tuple(int(i) for i in fields["efac_idx"]),
        efac_const=np.array(fields["efac_const"]),
        equad_masks=np.array(fields["equad_masks"]),
        equad_idx=tuple(int(i) for i in fields["equad_idx"]),
        equad_const=np.array(fields["equad_const"]),
        phi_blocks=tuple(_phi_block(b) for b in fields["phi_blocks"]),
        param_names=tuple(str(s) for s in fields["param_names"]),
        prior_specs=np.array(fields["prior_specs"]),
        row_mask=None if row_mask is None else np.array(row_mask),
        time_scale=float(fields.get("time_scale", 1e6)),
    )


def chain_state_from_arrays(arrays: Mapping, device=None,
                            dtype=torch.float32):
    """The port's batched ``ChainState`` from a mapping of numpy arrays
    with a leading chain axis, or ``(P, C)`` axes for an ensemble (a JAX
    ``ChainState._asdict()`` after ``jax.device_get``). Missing adaptation
    fields get their defaults: zero log-scales and an empty covariance
    factor. ``dtype`` is the state's (pass ``torch.float64`` for a
    ``dtype=torch.float64`` sampler, as for a JAX ``dtype=jnp.float64``
    run's state). ``device=None`` means ``"cuda"`` and raises when CUDA is
    absent, as ``TorchGibbs`` does."""
    from gibbs_student_t_tpu_torch.backends.torch_backend import (
        ChainState,
        resolve_device,
    )

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    batch = np.asarray(arrays["x"]).shape[:-1]
    ls = arrays.get("mh_log_scale")
    cov = arrays.get("mh_cov_chol")
    return ChainState(
        x=t(arrays["x"]), b=t(arrays["b"]), z=t(arrays["z"]),
        alpha=t(arrays["alpha"]), theta=t(arrays["theta"]),
        df=t(arrays["df"]), pout=t(arrays["pout"]),
        acc_white=t(arrays["acc_white"]), acc_hyper=t(arrays["acc_hyper"]),
        # an unbatched (2,) default (the JAX NamedTuple's) is per chain
        mh_log_scale=(t(np.broadcast_to(ls, (*batch, 2))) if ls is not None
                      else torch.zeros((*batch, 2), dtype=dtype,
                                       device=device)),
        mh_cov_chol=(t(cov) if cov is not None and np.size(cov)
                     else torch.zeros((*batch, 0), dtype=dtype,
                                      device=device)),
    )
