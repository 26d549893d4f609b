"""Validated ``GST_*`` gate values, read from the environment.

The JAX package reads its gates through ``ops.registry``; this package
reads the few it has with :func:`env_choice`: an unset variable is
``"auto"``, and a value outside the gate's choices raises a ``ValueError``
that names the variable and the value (a typo must never silently pick a
default). :func:`env_posint` reads a size the same way (the registry's
``posint`` kind): unset is the default, anything but a positive integer
raises.
"""

from __future__ import annotations

import os

#: the choices of an on/off gate: ``auto`` (the gate's default), on, off
MODE3 = ("auto", "1", "0")


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
