"""Run-configuration parser; a copy of ``seabreeze_param_tpu.io.config``
(the port imports no JAX package).

Capability-parity with the reference ``Config``
(``python_wrapper/seabreezediag/configdir.py:184-345``): an INI-ish
``key = value  # comment`` file becomes a dict with attribute access,
automatic type coercion (int, float, bool, None, comma tuples), ``$ENVVAR``
expansion, and quote/bracket stripping.  The canonical key schema is
``python_wrapper/run.conf:1-55`` (data dir, static-file paths, variable
names, start/end dates, target pressure level); see
:data:`CONFIG_SCHEMA` and ``examples/run.conf``.

Design differences from the reference (intentional, documented):
  * missing files raise ``FileNotFoundError`` instead of print-and-return
    with an empty dict (``configdir.py:278-280`` silently produced configs
    whose every later attribute access failed);
  * ``$VAR`` expansion uses ``os.path.expandvars`` semantics anywhere in
    the value (the reference only expanded a leading path component,
    ``configdir.py:284-292``) and still raises ``KeyError`` for unset
    variables like the reference did;
  * values may also be set/overridden programmatically via ``overrides``.
"""
from __future__ import annotations

import os
import re

# The canonical key set of run.conf (python_wrapper/run.conf:1-55), used by
# Meta/drivers; absent keys fall back to these defaults where sensible.
CONFIG_SCHEMA = {
    "datadir": None, "landfracfile": None, "topofile": None, "orofile": None,
    "prefix": "", "vtheta": "t2m", "vu": "u", "vv": "v",
    "vlon": "longitude", "vlat": "latitude", "vpres": "level", "vci": "ci",
    "vlandfrac": "lsm", "vz": "z", "vstd": "sdfor", "vtime": "time",
    "plev": 700, "start": None, "end": None,
}

_BLACKLIST = "[]{}@#\"'"


def _coerce(value: str, maketuple: bool):
    """int -> float -> bool/None -> comma tuple -> str, as the reference
    (configdir.py:320-341)."""
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "none":
        return None
    if maketuple and "," in value:
        out = []
        for item in value.split(","):
            item = item.strip().strip("()")
            try:
                out.append(float(item))
            except ValueError:
                out.append(item)
        return tuple(out)
    return value


def _expand_env(value):
    """Expand ``$VAR``/``${VAR}``; unset variables raise KeyError (the
    reference's contract, configdir.py:287-290)."""
    if not isinstance(value, str) or "$" not in value:
        return value
    for name in re.findall(r"\$\{?(\w+)\}?", value):
        if name not in os.environ:
            raise KeyError(f"Environment variable ${name} not set")
    return os.path.expandvars(value)


class Config(dict):
    """Parsed run configuration with attribute access.

    Parameters mirror the reference (``configdir.py:256``):

    filename : path of the config file (or None for an empty config built
        from ``overrides``).
    maketuple : interpret comma-separated values as tuples.
    skipwhitespace : drop blanks inside values.
    split : the key/value separator character.
    """

    def __init__(self, filename=None, maketuple=True, skipwhitespace=True,
                 split="=", **overrides):
        super().__init__()
        if filename is not None:
            with open(os.path.expanduser(str(filename))) as f:
                self._parse(f.read().splitlines(), maketuple, skipwhitespace,
                            split)
        for key, value in overrides.items():
            self[key] = value
        for key, value in list(self.items()):
            self[key] = _expand_env(value)

    # -- parsing -------------------------------------------------------
    def _parse(self, lines, maketuple, skipwhitespace, split):
        for line in lines:
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip()[0] in _BLACKLIST:
                continue
            if split not in line:
                continue
            key, _, value = line.partition(split)
            value = value.split("#", 1)[0]
            if skipwhitespace:
                value = value.replace(" ", "")
            else:
                value = value.strip()
            for ch in _BLACKLIST:
                value = value.replace(ch, "")
            self[key.strip()] = _coerce(value, maketuple)

    # -- attribute access ---------------------------------------------
    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Attribute {key!r} does not exist; available: "
                f"{sorted(self.keys())}") from None

    def __setattr__(self, key, value):
        self[key] = value

    def get_default(self, key):
        """Schema-aware lookup: the file's value, else the run.conf default."""
        if key in self:
            return self[key]
        if key in CONFIG_SCHEMA:
            return CONFIG_SCHEMA[key]
        raise KeyError(key)

    def __repr__(self):
        if not self:
            return "Config()"
        kw = max(len(str(k)) for k in self) + 1
        lines = [f"{'Keys':<{kw}}| Values", "-" * (kw + 9)]
        lines += [f"{k!s:<{kw}}| {v}" for k, v in self.items()]
        return "\n".join(lines)
