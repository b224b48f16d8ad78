"""Runtime configuration: an AMReX-ParmParse-compatible ``.in`` file reader.

The reference configures every run from plain-text ``.in`` files plus
command-line overrides (AMReX ``ParmParse``; keys documented in the reference
at ``docs/docs/parameters.md`` and read in ``src/simulation.hpp:541-636`` and
``src/QuokkaSimulation.hpp:340-396``).  This module reproduces that file
format so the reference's input decks work unchanged:

    # comment
    geometry.prob_lo = 0.0 0.0 0.0
    amr.n_cell = 256 256 256
    cfl = 0.3
    hydro.reconstruction_order = 3

Values are whitespace-separated lists; scalars are just one-element lists.
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Sequence


def _coerce(token: str) -> Any:
    """Convert a token to int, then float, else keep as string."""
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    low = token.lower()
    if low in ("true", "t"):
        return True
    if low in ("false", "f"):
        return False
    return token.strip('"')


class ParmParse:
    """String-keyed runtime configuration with namespaced keys.

    Mirrors the semantics the reference relies on: `get(key, default)`,
    typed accessors, and CLI-style `key=value` overrides taking precedence
    over file contents.
    """

    def __init__(self, table: Dict[str, List[Any]] | None = None):
        self.table: Dict[str, List[Any]] = dict(table or {})

    # ---------------------------------------------------------------- parsing
    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = ()) -> "ParmParse":
        with open(path, "r") as f:
            text = f.read()
        return cls.from_string(text, overrides)

    @classmethod
    def from_string(cls, text: str, overrides: Sequence[str] = ()) -> "ParmParse":
        pp = cls()
        pp._parse(text)
        for ov in overrides:
            pp._parse_line(ov)
        return pp

    def _parse(self, text: str) -> None:
        for raw_line in text.splitlines():
            self._parse_line(raw_line)

    def _parse_line(self, raw_line: str) -> None:
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            return
        if "=" not in line:
            return
        key, _, rhs = line.partition("=")
        key = key.strip()
        tokens = shlex.split(rhs.strip())
        if not key or not tokens:
            return
        self.table[key] = [_coerce(t) for t in tokens]

    # --------------------------------------------------------------- acessors
    def contains(self, key: str) -> bool:
        return key in self.table

    def get(self, key: str, default: Any = None) -> Any:
        """Return a scalar value (first element) or `default`."""
        if key not in self.table:
            return default
        vals = self.table[key]
        return vals[0] if len(vals) == 1 else list(vals)

    def get_list(self, key: str, default: Sequence[Any] | None = None) -> List[Any]:
        if key not in self.table:
            return list(default) if default is not None else []
        return list(self.table[key])

    def get_int(self, key: str, default: int | None = None) -> int:
        v = self.get(key, default)
        if v is None:
            raise KeyError(f"missing required config key: {key}")
        try:
            return int(v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"config key '{key}' is not an int: {self.table.get(key)}") from e

    def get_float(self, key: str, default: float | None = None) -> float:
        v = self.get(key, default)
        if v is None:
            raise KeyError(f"missing required config key: {key}")
        try:
            return float(v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"config key '{key}' is not a float: {self.table.get(key)}") from e

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        v = self.get(key, default)
        if v is None:
            raise KeyError(f"missing required config key: {key}")
        if isinstance(v, str):
            return v.lower() in ("1", "true", "t", "yes")
        return bool(v)

    def get_str(self, key: str, default: str | None = None) -> str:
        v = self.get(key, default)
        if v is None:
            raise KeyError(f"missing required config key: {key}")
        return str(v)

    def set(self, key: str, value: Any) -> None:
        self.table[key] = list(value) if isinstance(value, (list, tuple)) else [value]

    def namespace(self, prefix: str) -> "ParmParse":
        """Sub-view of all keys under `prefix.` (prefix stripped)."""
        p = prefix + "."
        return ParmParse({k[len(p):]: v for k, v in self.table.items() if k.startswith(p)})

    def __repr__(self) -> str:  # pragma: no cover
        return f"ParmParse({self.table!r})"
