"""Inverse text normalization (ITN) for Chinese (+ mixed English digits).

Counterpart of the JAX package's text/itn.py. Role of the reference's
WeTextProcessing-runtime port (itn-processor.cpp:53-87: tagger ->
reorder -> verbalizer, with ITN_ORDERS = date/fraction/money/measure/
time, itn-token-parser.cpp:25-45). Two engines:
- `ChineseITN`, the rule engine that the launcher installs by default
  (--itn): instead of compiled OpenFST grammars, rules over the same
  categories rewrite spelled-out Chinese numerals to digits in context
  (dates, times, fractions, percents, money, measures, plain
  cardinals/decimals, digit-string readings, 幺=1);
- `FstITN`, for exact WeTextProcessing output: it loads the compiled
  grammars deployments ship (zh_itn_tagger.fst / zh_itn_verbalizer.fst,
  com-define.h:76-80) through the native FST reader (native/src/fst.cc)
  and runs tag -> token reorder -> verbalize, each a composition with a
  shortest path in the native library.
"""
from __future__ import annotations

import re
from typing import Optional

_DIGITS = {"零": 0, "〇": 0, "一": 1, "幺": 1, "二": 2, "两": 2, "三": 3,
           "四": 4, "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_UNITS = {"十": 10, "百": 100, "千": 1000}
_BIG_UNITS = {"万": 10 ** 4, "亿": 10 ** 8}
_NUM_CHARS = "零〇一幺二两三四五六七八九十百千万亿"
_NUM_RE = f"[{_NUM_CHARS}]+"


def _parse_digit_string(s: str) -> Optional[str]:
    """二零二五 -> '2025' (digit-by-digit reading)."""
    out = []
    for ch in s:
        if ch not in _DIGITS:
            return None
        out.append(str(_DIGITS[ch]))
    return "".join(out)


def _parse_section(s: str) -> Optional[int]:
    """Parse a <万 section like 三千五百二十一 (incl. colloquial 三千五=3500)."""
    total = 0
    num = 0
    seen_unit = False
    last_unit = 0
    after_zero = False
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in _DIGITS:
            if ch in ("零", "〇"):
                num = 0
                after_zero = True
            else:
                num = _DIGITS[ch]
            i += 1
        elif ch in _UNITS:
            unit = _UNITS[ch]
            if num == 0:
                num = 1  # 十五 = 15
            total += num * unit
            num = 0
            seen_unit = True
            last_unit = unit
            after_zero = False
            i += 1
        else:
            return None
    if num:
        # trailing digit: colloquial half-unit (三千五 = 3500) unless an
        # explicit 零 pins it to the ones place (三千零五 = 3005)
        if seen_unit and not after_zero and last_unit >= 100:
            total += num * (last_unit // 10)
        else:
            total += num
    if not seen_unit and len(s) > 1 and all(c in _DIGITS for c in s):
        # multi-char pure digit sequence: read positionally (二零二五)
        return None
    return total


def parse_zh_number(s: str) -> Optional[str]:
    """Spelled Chinese numeral -> digit string, or None."""
    if not s or any(c not in _DIGITS and c not in _UNITS
                    and c not in _BIG_UNITS for c in s):
        return None
    if all(c in _DIGITS for c in s):
        if len(s) == 1:
            return str(_DIGITS[s])
        return _parse_digit_string(s)
    # split on 亿 then 万
    total = 0
    rest = s
    last_big = 0
    for ch, mul in (("亿", 10 ** 8), ("万", 10 ** 4)):
        if ch in rest:
            left, rest = rest.rsplit(ch, 1)
            sec = parse_zh_number(left) if left else "1"
            if sec is None or not sec.isdigit():
                return None
            total += int(sec) * mul
            last_big = mul
    if rest:
        if (last_big and len(rest) == 1 and rest in _DIGITS
                and rest not in ("零", "〇")):
            # colloquial half-unit after 万/亿: 两万五 = 25000
            total += _DIGITS[rest] * (last_big // 10)
        else:
            # handle leading 十 (十五 = 15); 三万零五百 picks up as-is
            sec = _parse_section(rest.lstrip("零〇"))
            if sec is None:
                return None
            total += sec
    return str(total)


def _num(m_str: str) -> str:
    v = parse_zh_number(m_str)
    return v if v is not None else m_str


# Words/idioms whose numeral chars are lexical, not quantities — the
# reference's FST grammar whitelists these the same way (tagger rules in
# the compiled zh_itn_tagger.fst; cf. itn-processor.cpp:53-87).
_PROTECTED_WORDS = (
    "一起", "一样", "一些", "一直", "一边", "一切", "一致", "一旦",
    "一般", "一再", "一同", "一时", "一味", "一面", "一下子", "一下",
    "一会儿", "一会", "一点点", "有一点", "一点儿", "一块儿", "一帆风顺",
    "一干二净", "一清二楚", "一心一意", "三心二意", "二话不说", "独一无二",
    "万一", "统一", "唯一", "专一", "单一", "合二为一", "不二", "一流",
    "一生", "一身", "一贯", "一律", "一共", "一向", "一度", "一带一路",
    "说一不二", "三七二十一", "乱七八糟", "五花八门", "七上八下",
    "四面八方", "千方百计", "千军万马", "五湖四海", "七嘴八舌",
    "九牛一毛", "十全十美", "一无所有", "一如既往", "下一步", "进一步",
    "一言为定", "五颜六色", "成千上万", "千变万化", "万无一失",
)

_PROTECTED_RE = re.compile(
    "|".join(sorted((re.escape(w) for w in _PROTECTED_WORDS),
                    key=len, reverse=True)))

# Measure units whose first char is also a numeral unit char (千克 etc.)
# MUST be matched as part of a measure rule or the numeral regex eats it.
_MEASURE_UNITS = (
    "千克", "千米", "千瓦时", "千瓦", "千卡", "千斤", "万米",
    "公斤", "公里", "公分", "摄氏度", "毫米", "毫升", "毫克", "厘米",
    "平方米", "立方米", "平方公里", "米", "克", "吨", "升", "度", "斤",
    "岁", "倍", "秒钟", "分钟", "小时", "天", "周", "个月", "英里", "英尺",
)


class ChineseITN:
    """normalize(text) -> text with ITN applied (ITNModel::Normalize role,
    itn-processor.cpp:85-87)."""

    def __init__(self, enable: bool = True):
        self.enable = enable
        num = _NUM_RE
        unit = "|".join(_MEASURE_UNITS)
        dig = "零〇一幺二两三四五六七八九十"  # chars that anchor a number
        # lazy numeral for unit rules: prefers the longest unit (千克,
        # 千瓦时, …) over folding the unit's 千 into the number; requires
        # a digit char so bare 千克/万 never parse as 1000/10000
        lnum = (f"[{_NUM_CHARS}]*?[{dig}][{_NUM_CHARS}]*?"
                f"(?:点[{_NUM_CHARS}]+?)?")
        self._rules = [
            # fraction / percent FIRST: 百/千/万 in 百分之… belong to the
            # category word, not to a numeral a later rule may grab
            (re.compile(f"(?<![{_NUM_CHARS}])百分之百"), lambda m: "100%"),
            (re.compile(f"负百分之({num}(?:点{num})?)"),
             lambda m: f"-{self._decimal(m.group(1))}%"),
            (re.compile(f"(?<![{_NUM_CHARS}])百分之({num}(?:点{num})?)"),
             lambda m: f"{self._decimal(m.group(1))}%"),
            (re.compile(f"(?<![{_NUM_CHARS}])千分之({num}(?:点{num})?)"),
             lambda m: f"{self._decimal(m.group(1))}‰"),
            (re.compile(f"负({num})分之({num})"),
             lambda m: f"-{_num(m.group(2))}/{_num(m.group(1))}"),
            (re.compile(f"({num})分之({num})"),
             lambda m: f"{_num(m.group(2))}/{_num(m.group(1))}"),
            # negatives with a measure unit first, then bare
            (re.compile(f"负({lnum})({unit})"),
             lambda m: f"-{self._decimal(m.group(1))}{m.group(2)}"),
            (re.compile(f"零下({lnum})({unit})"),
             lambda m: f"-{self._decimal(m.group(1))}{m.group(2)}"),
            (re.compile(f"零下({num}(?:点{num})?)"),
             lambda m: f"-{self._decimal(m.group(1))}"),
            (re.compile(f"负({num}(?:点{num})?)"),
             lambda m: f"-{self._decimal(m.group(1))}"),
            # measure with a 万/亿 number: greedy so 两万五千米 = 25000米
            # (the 千 belongs to the number) — but the tail after 万/亿
            # must contain a digit char, so 一万千米 stays 10000 千米
            # (bare 千 is the unit's, not a numeral)
            (re.compile(f"([{_NUM_CHARS}]*[万亿]"
                        f"(?:[{_NUM_CHARS}]*[{dig}][{_NUM_CHARS}]*)?"
                        f"(?:点[{_NUM_CHARS}]+)?)({unit})"),
             lambda m: f"{self._decimal(m.group(1))}{m.group(2)}"),
            # measure: number + unit (ITN_ORDERS "measure" category,
            # itn-token-parser.cpp:25-45)
            (re.compile(f"({lnum})({unit})"),
             lambda m: f"{self._decimal(m.group(1))}{m.group(2)}"),
            # date: X年X月X日/号
            (re.compile(f"({num})年({num})月({num})[日号]"),
             lambda m: f"{self._year(m.group(1))}年{_num(m.group(2))}月"
                       f"{_num(m.group(3))}日"),
            (re.compile(f"({num})月({num})[日号]"),
             lambda m: f"{_num(m.group(1))}月{_num(m.group(2))}日"),
            (re.compile(f"({num})年"),
             lambda m: f"{self._year(m.group(1))}年"),
            # time: X点X分X秒 / X点半 / X时X分
            (re.compile(f"({num})[点时]({num})分({num})秒"),
             lambda m: f"{_num(m.group(1))}:{self._two(m.group(2))}:"
                       f"{self._two(m.group(3))}"),
            (re.compile(f"({num})[点时]({num})分"),
             lambda m: f"{_num(m.group(1))}:{self._two(m.group(2))}"),
            (re.compile(f"({num})点半"),
             lambda m: f"{_num(m.group(1))}:30"),
            # money with sub-units (角/毛 = 0.1元, 分 = 0.01元):
            # X元Y角Z分 / X块Y毛 / X块零Z分 / X块Y (trailing digit = 角)
            (re.compile(f"({num})[元块]({num})[角毛]({num})分"),
             lambda m: self._yuan(m.group(1), m.group(2), m.group(3))),
            (re.compile(f"({num})[元块]零({num})分"),
             lambda m: self._yuan(m.group(1), "零", m.group(2))),
            (re.compile(f"({num})[元块]({num})分"),
             lambda m: self._yuan(m.group(1), "零", m.group(2))),
            (re.compile(f"({num})[元块]({num})[角毛]钱?"),
             lambda m: self._yuan(m.group(1), m.group(2))),
            (re.compile(f"({num})块([一两二三四五六七八九])"
                        f"(?![{_NUM_CHARS}角毛分])"),
             lambda m: self._yuan(m.group(1), m.group(2))),
            (re.compile(f"({num})[角毛]({num})分"),
             lambda m: self._yuan("零", m.group(1), m.group(2))),
            (re.compile(f"({num})[角毛]钱?(?!度|色)"),
             lambda m: self._yuan("零", m.group(1))),
            (re.compile(f"({num})分钱"),
             lambda m: self._yuan("零", "零", m.group(1))),
            # money: X元/块/块钱
            (re.compile(f"({num}(?:点{num})?)[元](?!素)"),
             lambda m: f"{self._decimal(m.group(1))}元"),
            (re.compile(f"({num}(?:点{num})?)块钱?"),
             lambda m: f"{self._decimal(m.group(1))}元"),
            # decimal
            (re.compile(f"({num})点({num})"),
             lambda m: self._decimal(f"{m.group(1)}点{m.group(2)}")),
            # ordinal: 第X -> 第N
            (re.compile(f"第({num})"), lambda m: f"第{_num(m.group(1))}"),
            # plain cardinal (longest spans last); must contain a digit
            # char so a lone unit char (千米's 千) is never a number
            (re.compile(f"[{_NUM_CHARS}]*[{dig}][{_NUM_CHARS}]*"),
             lambda m: _num(m.group(0))),
        ]

    @staticmethod
    def _two(s: str) -> str:
        v = _num(s)
        return v.zfill(2) if v.isdigit() else v

    @staticmethod
    def _year(s: str) -> str:
        d = _parse_digit_string(s)
        if d is not None and len(d) >= 2:
            return d
        return _num(s)

    @staticmethod
    def _yuan(yuan: str, jiao: str = "零", fen: str = "零") -> str:
        """Compose 元/角/分 into a decimal amount: (五, 三, 二) -> 5.32元."""
        y, j, f = (_num(yuan), _num(jiao), _num(fen))
        if not (y.isdigit() and j.isdigit() and f.isdigit()):
            return f"{yuan}元"
        cents = int(j) * 10 + int(f)
        if cents == 0:
            return f"{y}元"
        frac = f"{cents:02d}".rstrip("0") if cents % 10 == 0 \
            else f"{cents:02d}"
        return f"{y}.{frac}元"

    @staticmethod
    def _decimal(s: str) -> str:
        if "点" in s:
            a, b = s.split("点", 1)
            ai = parse_zh_number(a)
            bi = _parse_digit_string(b)
            if ai is not None and bi is not None:
                return f"{ai}.{bi}"
            return s
        return _num(s)

    def normalize(self, text: str) -> str:
        if not self.enable or not text:
            return text
        # shield lexical uses of numeral chars (一起, 万一, …) from the
        # numeric grammar, longest match first
        shielded: list = []

        def _shield(m):
            shielded.append(m.group(0))
            return f"\x00{len(shielded) - 1}\x01"

        out = _PROTECTED_RE.sub(_shield, text)
        for pattern, repl in self._rules:
            # each rule's output is shielded so later rules never
            # re-parse it — first matching category wins, like the
            # reference's single tagger∘verbalizer shortest path
            def _apply(m, _repl=repl):
                shielded.append(_repl(m))
                return f"\x00{len(shielded) - 1}\x01"

            out = pattern.sub(_apply, out)
        if shielded:
            out = re.sub(
                "\x00(\\d+)\x01", lambda m: shielded[int(m.group(1))], out)
        return out


# ---------------------------------------------------------------------------
# FST-backed ITN: the compiled WeTextProcessing grammars the reference uses
# (itn-processor.cpp:31-87)
# ---------------------------------------------------------------------------

ITN_ORDERS = {
    "date": ["year", "month", "day"],
    "fraction": ["sign", "numerator", "denominator"],
    "measure": ["numerator", "denominator", "value"],
    "money": ["currency", "value"],
    "time": ["hour", "minute", "second", "noon"],
}
TN_ORDERS = {
    "date": ["year", "month", "day"],
    "fraction": ["denominator", "numerator"],
    "measure": ["denominator", "numerator", "value"],
    "money": ["value", "currency"],
    "time": ["noon", "hour", "minute", "second"],
}
_KEY_CHARS = set("abcdefghijklmnopqrstuvwxyz"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")


def reorder_tagged_tokens(tagged: str, orders=None) -> str:
    """Parse the tagger's `name { key: "value" ... }` records and write
    each again with its category's canonical field order: the
    TokenParser::reorder step between tagging and verbalization
    (itn-token-parser.cpp:25-45)."""
    if orders is None:
        orders = ITN_ORDERS
    i, n = 0, len(tagged)
    out_tokens = []
    while i < n:
        while i < n and tagged[i] == " ":
            i += 1
        if i >= n:
            break
        j = i
        while j < n and tagged[j] in _KEY_CHARS:
            j += 1
        name = tagged[i:j]
        i = j
        while i < n and tagged[i] in " {":
            i += 1
        fields = []          # (key, value) in appearance order
        while i < n:
            while i < n and tagged[i] == " ":
                i += 1
            if i < n and tagged[i] == "}":
                i += 1
                break
            j = i
            while j < n and tagged[j] in _KEY_CHARS:
                j += 1
            key = tagged[i:j]
            i = j
            while i < n and tagged[i] in ': "':
                i += 1
                if tagged[i - 1] == '"':
                    break
            j = i
            val = []
            while j < n and tagged[j] != '"':
                if tagged[j] == "\\" and j + 1 < n:
                    val.append(tagged[j])
                    j += 1
                val.append(tagged[j])
                j += 1
            i = j + 1
            fields.append((key, "".join(val)))
        members = dict(fields)
        order = orders.get(name, [k for k, _ in fields])
        parts = [f'{k}: "{members[k]}"' for k in order if k in members]
        out_tokens.append(f"{name} {{ {' '.join(parts)} }}")
    return " ".join(out_tokens)


class FstITN:
    """ITN through compiled tagger and verbalizer FSTs, byte by byte, as
    the reference runtime does it (itn-processor.cpp:53-87):
    normalize(x) = verbalize(reorder(tag(x))). Text that the tagger does
    not accept comes back unchanged, as does a tagging that the
    verbalizer does not accept.

    Takes the reference's artifact names (zh_itn_tagger.fst /
    zh_itn_verbalizer.fst) or any WeTextProcessing export; `kind` ("itn"
    or "tn", the field orders) follows the reference's `_tn_`/`_itn_`
    file names when not given. A grammar that cannot be read raises
    ValueError."""

    def __init__(self, tagger_path: str, verbalizer_path: str,
                 kind: Optional[str] = None):
        from asr2pass_tpu_torch.native.bindings import NativeFst

        self.tagger = NativeFst(tagger_path)
        self.verbalizer = NativeFst(verbalizer_path)
        if kind is None:
            kind = "tn" if "_tn_" in str(tagger_path) else "itn"
        self.orders = TN_ORDERS if kind == "tn" else ITN_ORDERS

    @staticmethod
    def _compose(fst, text: str):
        """(accepted, text): the grammar's best output for the bytes of
        `text`."""
        ok, out = fst.transduce(list(text.encode("utf-8")))
        return ok, bytes(b & 0xFF for b in out).decode("utf-8", "replace")

    def normalize(self, text: str) -> str:
        if not text:
            return text
        ok, tagged = self._compose(self.tagger, text)
        if not ok or not tagged:
            return text
        ok, out = self._compose(self.verbalizer,
                                reorder_tagged_tokens(tagged, self.orders))
        return out if ok else text
