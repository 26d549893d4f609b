"""Validated ``GST_*`` gate values, read from the environment.

The JAX package reads its gates through ``ops.registry``; this package
reads the few it has with :func:`env_choice`: an unset variable is
``"auto"``, and a value outside the gate's choices raises a ``ValueError``
that names the variable and the value (a typo must never silently pick a
default). :func:`env_posint` reads a size the same way (the registry's
``posint`` kind): unset is the default, anything but a positive integer
raises. :func:`env_offswitch` reads a default-on layer switch (the
registry's ``offswitch`` kind).

The gates read here, each where its layer is built: ``GST_KERNEL_TIMERS``
(strict ``auto|1|0``, auto -> off here, on in the JAX package: the
sweep's stage timers, ops/timers.py), ``GST_INTROSPECT`` (off switch: the run's kernel and
program records, obs/introspect.py), ``GST_SERVE_WATCHDOG``,
``GST_RECYCLE``, ``GST_WARM_START``, ``GST_WARM_FLOW``,
``GST_ADAPT_SCAN``, ``GST_SERVE_SCATTER`` (strict ``auto|1|0``, auto ->
on: the slot pool's admission writes on the device, ``0`` the host
bounce, serve/pool.py) and ``GST_RPC_MAX_FRAME``.
"""

from __future__ import annotations

import os

#: the choices of an on/off gate: ``auto`` (the gate's default), on, off
MODE3 = ("auto", "1", "0")
#: the values of an off switch that keep its layer on, and those that turn
#: it off (the JAX registry's ``offswitch``: ``0``, ``false`` or empty)
SWITCH_ON = ("auto", "1", "true")
SWITCH_OFF = ("0", "false", "")


def env_choice(name: str, values=MODE3) -> str:
    """The value of ``name`` (``"auto"`` when unset), strictly one of
    ``values``."""
    env = os.environ.get(name)
    if env is not None and env not in values:
        pretty = ", ".join(f"'{v}'" for v in values[:-1])
        raise ValueError(f"{name} must be {pretty} or '{values[-1]}', got "
                         f"{env!r}")
    return env if env is not None else "auto"


def env_posint(name: str, default: int) -> int:
    """The value of ``name`` (``default`` when unset), strictly a positive
    integer."""
    env = os.environ.get(name)
    if env is None:
        return default
    try:
        v = int(env)
    except ValueError:
        v = -1
    if v <= 0:
        raise ValueError(f"{name} must be a positive integer (bytes), got "
                         f"{env!r}")
    return v


def env_offswitch(name: str) -> bool:
    """Whether the default-on layer ``name`` switches is on: unset, or one
    of :data:`SWITCH_ON`; off for one of :data:`SWITCH_OFF`; any other
    value raises."""
    env = os.environ.get(name)
    if env is None or env in SWITCH_ON:
        return True
    if env in SWITCH_OFF:
        return False
    raise ValueError(f"{name} must be one of "
                     f"{', '.join(repr(v) for v in SWITCH_ON + SWITCH_OFF)}"
                     f", got {env!r}")
