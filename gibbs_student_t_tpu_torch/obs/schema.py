"""Schema validation for the observability records.

Counterpart of ``gibbs_student_t_tpu/obs/schema.py``: the same small
JSON-Schema validator (``type`` incl. lists, ``properties``,
``required``, ``items``, ``enum``, ``additionalProperties`` as ``false``
or as a schema applied to every non-``properties`` key, ``anyOf`` and
the ``$named`` cross-reference; unknown keywords are ignored), over this
package's own copy of the schemas, ``observability.schema.json`` beside
this module. That copy differs from the reference's
``docs/observability.schema.json`` only where this package's records do
by design; its ``_comment`` lists each difference (the run manifest
names ``torch_version`` and ``cuda_version``, the ledger record has no
``xla``). tests/test_torch_serve_obs.py and ``chip_smoke.py`` validate
every record the serving plane emits against it.
"""

from __future__ import annotations

import json
import os
from typing import List

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "observability.schema.json")


def load_schemas(path: str = None) -> dict:
    """The named-schema table from ``observability.schema.json``
    (``{"ledger_record": {...}, "event": {...}, ...}``)."""
    with open(path or SCHEMA_PATH) as fh:
        return json.load(fh)


def _type_ok(value, t: str) -> bool:
    if t == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, _TYPES[t])


def validate(value, schema: dict, path: str = "$",
             defs: dict = None) -> List[str]:
    """Collect (not raise) every violation of ``schema`` by ``value``
    as human-readable ``path: problem`` strings; empty list == valid.
    ``defs`` is the named-schema table for ``{"$named": "..."}``
    cross-references (e.g. the shared percentiles shape)."""
    if "$named" in schema:
        if not defs or schema["$named"] not in defs:
            return [f"{path}: unresolvable $named "
                    f"{schema['$named']!r}"]
        schema = defs[schema["$named"]]
    errs: List[str] = []
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, tt) for tt in types):
            return [f"{path}: expected {t}, got "
                    f"{type(value).__name__} ({value!r:.80})"]
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in {schema['enum']}")
    if "anyOf" in schema:
        branches = [validate(value, s, path, defs)
                    for s in schema["anyOf"]]
        if not any(not b for b in branches):
            errs.append(f"{path}: matched no anyOf branch "
                        f"({branches[0][0] if branches[0] else ''})")
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for key in schema.get("required", []):
            if key not in value:
                errs.append(f"{path}: missing required key {key!r}")
        for key, sub in props.items():
            if key in value:
                errs.extend(validate(value[key], sub, f"{path}.{key}",
                                     defs))
        ap = schema.get("additionalProperties")
        if ap is False:
            for key in value:
                if key not in props:
                    errs.append(f"{path}: unexpected key {key!r}")
        elif isinstance(ap, dict):
            for key in value:
                if key not in props:
                    errs.extend(validate(value[key], ap,
                                         f"{path}.{key}", defs))
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            errs.extend(validate(item, schema["items"],
                                 f"{path}[{i}]", defs))
    return errs


def assert_valid(value, schema: dict, label: str = "record",
                 defs: dict = None) -> None:
    """Raise ``AssertionError`` listing every violation (the test-side
    entry point — one failure names every drifted field at once)."""
    errs = validate(value, schema, defs=defs)
    if errs:
        raise AssertionError(
            f"{label} violates its schema "
            f"({len(errs)} problem(s)):\n  " + "\n  ".join(errs[:20]))
