"""`--section.key value` config overrides, as the JAX package's CLIs take them."""

from __future__ import annotations

import json


def parse_kv_overrides(rest):
    """`--section.key value` / `--section.key=value` pairs -> dict; values
    parse as JSON where they can, else stay strings."""
    overrides = {}
    it = iter(rest)
    for key in it:
        if not key.startswith("--"):
            raise SystemExit(f"expected --section.key, got {key}")
        if "=" in key:
            key, raw = key.split("=", 1)
        else:
            raw = next(it, None)
            if raw is None:
                raise SystemExit(f"missing value for {key}")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        overrides[key[2:]] = value
    return overrides


def overrides_to_args(overrides: dict) -> list:
    """The `--section.key value` pairs that `parse_kv_overrides` reads back
    as `overrides` (strings as they are, other values as JSON)."""
    return [a for k, v in overrides.items()
            for a in (f"--{k}", v if isinstance(v, str) else json.dumps(v))]
