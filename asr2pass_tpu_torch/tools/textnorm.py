#!/usr/bin/env python3
"""Forward Chinese text normalization (textnorm_zh.py role): digits,
percents, decimals and common symbols -> spelled-out Chinese, for LM corpus
preparation (the inverse of text/itn.py).

Port copy of the JAX package's tools/textnorm.py (plain text code, the
same output).

CLI: python -m asr2pass_tpu_torch.tools.textnorm < in.txt > out.txt
"""
from __future__ import annotations

import re
import sys

_DIG = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_BIG = ["", "万", "亿"]


def int_to_zh(n: int) -> str:
    if n == 0:
        return "零"
    if n < 0:
        return "负" + int_to_zh(-n)
    parts = []
    big_i = 0
    while n > 0:
        sec = n % 10000
        n //= 10000
        if sec:
            zh = _section_to_zh(sec) + _BIG[big_i]
            # a section with leading zeros under a higher section reads 零
            # (三万零五百)
            if sec < 1000 and n > 0:
                zh = "零" + zh
            parts.append(zh)
        big_i += 1
    out = "".join(reversed(parts))
    # 一十X -> 十X at the front (conventional reading)
    if out.startswith("一十"):
        out = out[1:]
    return out.rstrip("零") or "零"


def _section_to_zh(sec: int) -> str:
    out = []
    zero_pending = False
    for i in range(3, -1, -1):
        d = (sec // 10 ** i) % 10
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(_DIG[d] + _UNITS[i])
    return "".join(out)


def digits_to_zh(s: str) -> str:
    """Positional reading: 2025 -> 二零二五 (for years, phone numbers)."""
    return "".join(_DIG[int(c)] for c in s if c.isdigit())


def normalize_zh(text: str) -> str:
    """Numbers/symbols -> Chinese readings."""
    def num_repl(m):
        s = m.group(0)
        if "." in s:
            a, b = s.split(".", 1)
            return int_to_zh(int(a)) + "点" + digits_to_zh(b)
        # long digit strings (phone-like) read positionally
        if len(s) > 8 or s.startswith("0"):
            return digits_to_zh(s)
        return int_to_zh(int(s))

    text = re.sub(r"(\d+(?:\.\d+)?)%", lambda m: "百分之"
                  + num_repl(re.match(r"\d+(?:\.\d+)?", m.group(1))), text)
    text = re.sub(r"\d+\.\d+|\d+", num_repl, text)
    for sym, rd in [("+", "加"), ("-", "减"), ("×", "乘"), ("÷", "除以"),
                    ("=", "等于"), ("℃", "摄氏度"), ("$", "美元"),
                    ("￥", "元"), ("%", "百分之")]:
        text = text.replace(sym, rd)
    return text


def main(argv=None):
    for line in sys.stdin:
        sys.stdout.write(normalize_zh(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
