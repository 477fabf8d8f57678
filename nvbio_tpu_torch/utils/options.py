"""Typed option maps + config-file parsing (a copy of
``nvbio_tpu/utils/options.py``: ``map --config`` overlays a file of
``key=value`` lines onto ``MapParams``).

Counterpart of the reference's ``nvbio/basic/options.h:57-141``
(``uint_option``/``string_option`` over a string->string map) and nvBowtie's
config files (``nvBowtie/bowtie2/cuda/params.cpp`` ``parse_options`` /
``load_options``): options arrive as ``key=value`` strings from the command
line or one-per-line files, later queries read them with typed defaults.
"""

from __future__ import annotations


class Options:
    def __init__(self, pairs=None):
        self._map: dict[str, str] = {}
        if pairs:
            for item in pairs:
                self.parse(item)

    def parse(self, item: str) -> None:
        """Accept 'key=value' or bare 'key' (-> '1', a boolean flag)."""
        item = item.strip()
        if not item or item.startswith("#"):
            return
        if "=" in item:
            k, v = item.split("=", 1)
            self._map[k.strip()] = v.strip()
        else:
            self._map[item] = "1"

    @classmethod
    def load(cls, path: str) -> "Options":
        """One option per line; '#' comments (reference load_options)."""
        opts = cls()
        with open(path) as f:
            for line in f:
                opts.parse(line)
        return opts

    def uint(self, name: str, default: int = 0) -> int:
        return int(self._map.get(name, default))

    def int(self, name: str, default: int = 0) -> int:
        return int(self._map.get(name, default))

    def float(self, name: str, default: float = 0.0) -> float:
        return float(self._map.get(name, default))

    def string(self, name: str, default: str = "") -> str:
        return self._map.get(name, default)

    def flag(self, name: str, default: bool = False) -> bool:
        v = self._map.get(name)
        if v is None:
            return default
        return v.lower() not in ("0", "false", "no", "off")

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def items(self):
        return self._map.items()


def apply_to_params(opts: Options, params):
    """Overlay an Options map onto a dataclass (e.g. MapParams): every key
    matching a field name is parsed with the field's type."""
    import dataclasses

    updates = {}
    for f in dataclasses.fields(params):
        if f.name in opts:
            cur = getattr(params, f.name)
            if isinstance(cur, bool):
                updates[f.name] = opts.flag(f.name)
            elif isinstance(cur, int):
                updates[f.name] = opts.int(f.name)
            elif isinstance(cur, float):
                updates[f.name] = opts.float(f.name)
            else:
                updates[f.name] = opts.string(f.name, str(cur))
    return dataclasses.replace(params, **updates) if updates else params
