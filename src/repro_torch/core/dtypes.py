"""One dtype-name -> byte-width table (stdlib-only).

The port's own copy of ``repro/core/dtypes.py``: ``repro_torch`` imports
nothing of the JAX package, so it carries this table itself. The text
below is the reference's and describes the reference's modules.

Three copies of this table used to exist — ``core/census.py:_BYTES``
(ladder names, no f8), ``launch/hloparse.py:_DTYPE_BYTES`` (HLO shape
names) and the implicit widths in the quantized collectives — and they
had already drifted (census lacked the f8 variants).  This module is the
single source of truth; the old names are re-exported where they were.

Two alphabets share the table:

* **ladder names** — the ``repro.core.precision`` alphabet (``int8``,
  ``f16``, ``bf16``, ``f32``, ``f64``) plus the f8 variants the paper's
  ladder may grow into.
* **HLO shape names** — what ``compiled.as_text()`` prints inside shape
  brackets (``f32[4,4]``, ``u16[...]``, ``pred[]``...).

No jax import here: ``tools/`` and the audit lint pack consume this from
stdlib-only contexts.
"""
from __future__ import annotations

#: canonical dtype name -> bytes per element (both alphabets merged)
BYTES = {
    # ladder / jax-style names
    "int8": 1, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "f8e4m3": 1, "f8e5m2": 1,
    # HLO shape-string names
    "f8e4m3fn": 1, "f8e4m3fnuz": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 1, "u4": 1, "pred": 1,
    "c64": 8, "c128": 16,
}

#: ladder-name subset (what :mod:`repro.core.census` prices)
LADDER_BYTES = {k: BYTES[k] for k in
                ("int8", "f16", "bf16", "f32", "f64", "f8e4m3", "f8e5m2")}

#: ladder name -> HLO dtype its wire/container representation uses.
#: 16-bit floats cross collectives bitcast to u16 (see
#: ``core/distributed._gather_panel``); int8 rides as s8; wide floats go
#: as themselves.  The HLO-side auditor keys collective bytes on these.
WIRE_DTYPE = {"int8": "s8", "f16": "u16", "bf16": "u16",
              "f8e4m3": "u8", "f8e5m2": "u8", "f32": "f32", "f64": "f64"}


#: numpy dtype name -> HLO shape-string name (what ``compiled.as_text()``
#: prints); the auditor maps traced avals onto HLO census keys with this.
NP_TO_HLO = {"float64": "f64", "float32": "f32", "float16": "f16",
             "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3fn",
             "float8_e5m2": "f8e5m2", "int64": "s64", "uint64": "u64",
             "int32": "s32", "uint32": "u32", "int16": "s16",
             "uint16": "u16", "int8": "s8", "uint8": "u8", "bool": "pred",
             "complex64": "c64", "complex128": "c128"}


def bytes_of(name: str) -> int:
    """Byte width of a dtype name from either alphabet (KeyError if
    unknown — an unknown dtype in a census is a parse bug, not 0 bytes)."""
    return BYTES[name]


def shape_regex_alternation() -> str:
    """``|``-joined dtype names for HLO shape regexes, longest first so
    ``f8e4m3fn`` wins over its ``f8e4m3`` prefix."""
    return "|".join(sorted(BYTES, key=len, reverse=True))
