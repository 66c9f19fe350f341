#!/usr/bin/env python3
r"""Write ``svs_tpu_torch/embeddings/_unicode_data.py``: the code-point
ranges of the Unicode properties the port's tokenizers test characters
against, read from the ``regex`` package's Unicode tables: those that cut
extended grapheme clusters (UAX #29; ``tokenizers``' ``Precompiled``
normalizer works cluster by cluster), and the letter, number, white-space
and word-character classes of the split patterns that ``tokenizers``
compiles with Oniguruma or Rust's ``regex`` (GPT-2's byte-level split,
``Whitespace``).  Python's ``re`` has no ``\p{...}`` and the tokenizers
run where ``regex`` is not installed, so the ranges are written out once:

    python3 tools/gen_unicode_data.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import regex

PROPERTIES = {
    "CONTROL": r"\p{Grapheme_Cluster_Break=Control}",
    "EXTEND": r"\p{Grapheme_Cluster_Break=Extend}",
    "SPACING_MARK": r"\p{Grapheme_Cluster_Break=SpacingMark}",
    "PREPEND": r"\p{Grapheme_Cluster_Break=Prepend}",
    "REGIONAL_INDICATOR": r"\p{Grapheme_Cluster_Break=Regional_Indicator}",
    "HANGUL_L": r"\p{Grapheme_Cluster_Break=L}",
    "HANGUL_V": r"\p{Grapheme_Cluster_Break=V}",
    "HANGUL_T": r"\p{Grapheme_Cluster_Break=T}",
    "HANGUL_LV": r"\p{Grapheme_Cluster_Break=LV}",
    "HANGUL_LVT": r"\p{Grapheme_Cluster_Break=LVT}",
    "EXTENDED_PICTOGRAPHIC": r"\p{Extended_Pictographic}",
    "INCB_CONSONANT": r"\p{Indic_Conjunct_Break=Consonant}",
    "INCB_EXTEND": r"\p{Indic_Conjunct_Break=Extend}",
    "INCB_LINKER": r"\p{Indic_Conjunct_Break=Linker}",
    "LETTER": r"\p{L}",
    "NUMBER": r"\p{N}",
    "WHITE_SPACE": r"\p{White_Space}",
    # Rust regex's Unicode \w
    "WORD": r"[\p{Alphabetic}\p{M}\p{Nd}\p{Pc}\p{Join_Control}]",
}


def ranges(pattern: str) -> list:
    rx = regex.compile(pattern)
    out: list = []
    for cp in range(0x110000):
        if rx.match(chr(cp)):
            if out and out[-1][1] == cp - 1:
                out[-1][1] = cp
            else:
                out.append([cp, cp])
    return [tuple(r) for r in out]


def main() -> int:
    target = Path(__file__).resolve().parent.parent / "svs_tpu_torch" / "embeddings" / "_unicode_data.py"
    lines = [
        '"""Code-point ranges (inclusive) of the Unicode properties that the',
        "port's tokenizers test characters against.  Generated by",
        f"``tools/gen_unicode_data.py`` from the ``regex`` package {regex.__version__}'s",
        "tables; do not edit.",
        '"""',
        "",
    ]
    for name, pattern in PROPERTIES.items():
        rs = ranges(pattern)
        lines.append(f"{name} = (")
        row = []
        for a, b in rs:
            row.append(f"(0x{a:X}, 0x{b:X}),")
            if len(row) == 4:
                lines.append("    " + " ".join(row))
                row = []
        if row:
            lines.append("    " + " ".join(row))
        lines.append(")")
        lines.append("")
    target.write_text("\n".join(lines), encoding="utf-8")
    print(f"wrote {target}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
