"""Chinese text normalization, parity-exact with the reference package.

Re-implements the behavior of text_utils/chn_text_norm (text.py:1-177 and
its cardinal/digit/date/fraction/money/percentage/telephone classes) as one
table-driven module.  The normalization direction (digits -> spoken Chinese)
is what the training text pipeline needs (hf_stream_dataloader.py:236); the
dispatcher's pattern order and its first-occurrence string replacement are
part of the observable behavior and are reproduced faithfully.

The port's own copy of `streamvoiceanon_tpu.utils.cn_norm`.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# number reading (num2chn equivalent, "mid" numbering: 兆 = 1e12)
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
# (power, char), ascending; smaller units 十百千万 then 亿 and up (mid system)
_UNITS: List[Tuple[int, str]] = [(1, "十"), (2, "百"), (3, "千"), (4, "万")] + [
    (8 + 4 * i, c) for i, c in enumerate("亿兆京垓秭穰沟涧正载")
]

# symbol kinds in the flat reading: ("d", value) digit, ("u", power, char)
# unit, ("p",) decimal point
_Sym = Tuple


def _int_symbols(value_string: str) -> List[_Sym]:
    """Flatten an integer digit-string into digit/unit symbols.  The
    recursion keeps a leading zero marker when a stripped group had leading
    zeros (一万【零】二百零三)."""
    stripped = value_string.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        d = [("d", int(stripped))]
        if len(value_string) != len(stripped):
            return [("d", 0)] + d
        return d
    power, char = max((pu for pu in _UNITS if pu[0] < len(stripped)))
    return (
        _int_symbols(value_string[:-power])
        + [("u", power, char)]
        + _int_symbols(stripped[-power:])
    )


def _apply_liang(symbols: List[_Sym]) -> List[str]:
    """Render symbols, converting 二 to 两 in front of units above 十 when
    not itself preceded by 十 (两千/两万/两亿 but 二十/一十二)."""
    out = []
    for i, s in enumerate(symbols):
        if s[0] == "d" and s[1] == 2:
            nxt = symbols[i + 1] if i + 1 < len(symbols) else None
            prv = symbols[i - 1] if i > 0 else None
            if (
                nxt is not None and nxt[0] == "u" and nxt[1] != 1
                and (prv is None or (prv[0] == "u" and prv[1] != 1))
            ):
                out.append("两")
                continue
        if s[0] == "d":
            out.append(_DIGITS[s[1]])
        elif s[0] == "u":
            out.append(s[2])
        else:
            out.append("点")
    return out


def num_to_cn(number_string: str, *, use_units: bool = True,
              alt_two: bool = True) -> str:
    """Digit string (optionally with one '.') -> Chinese reading.
    use_units=False gives the digit-by-digit reading (编号/电话)."""
    int_dec = number_string.split(".")
    int_string = int_dec[0]
    dec_string = int_dec[1] if len(int_dec) == 2 else ""
    if use_units and len(int_string) > 1:
        symbols = _int_symbols(int_string)
    else:
        symbols = [("d", int(c)) for c in int_string]
    if dec_string:
        symbols += [("p",)] + [("d", int(c)) for c in dec_string]
    if alt_two:
        chars = _apply_liang(symbols)
    else:
        chars = [
            _DIGITS[s[1]] if s[0] == "d" else (s[2] if s[0] == "u" else "点")
            for s in symbols
        ]
    result = "".join(chars)
    if result.startswith("点"):
        result = _DIGITS[0] + result
    if len(result) >= 2 and result[0] == "一" and result[1] == "十":
        result = result[1:]  # 一十二 -> 十二
    return result


def digits_to_cn(digit_string: str) -> str:
    """Digit-by-digit reading (Digit.digit2chntext)."""
    return num_to_cn(digit_string, use_units=False, alt_two=False)


# ---------------------------------------------------------------------------
# sub-normalizers (one per reference class)
# ---------------------------------------------------------------------------


def _date_to_cn(date: str) -> str:
    """Date.date2chntext: year digit-wise, month/day as cardinals."""
    year = month = day = ""
    other = date
    if "年" in date:
        y, other = date.strip().split("年", 1)
        year = digits_to_cn(y) + "年"
    if other:
        if "月" in other:
            m, day = other.strip().split("月", 1)
            month = num_to_cn(m) + "月"
        else:
            day = date  # quirk preserved: unreachable through the dispatcher
            month = ""
        if day:
            day = num_to_cn(day[:-1]) + day[-1]
    return year + month + day


def _money_to_cn(money: str) -> str:
    """Money.money2chntext: every number inside the money expression becomes
    a cardinal (unbounded str.replace, as in the reference)."""
    for m in re.findall(r"(\d+(\.\d+)?)", money):
        money = money.replace(m[0], num_to_cn(m[0]))
    return money


def _telephone_to_cn(telephone: str, fixed: bool = False) -> str:
    if fixed:
        parts = telephone.split("-")
    else:
        parts = telephone.strip("+").split()
    return "".join(digits_to_cn(p) for p in parts)


def _fraction_to_cn(fraction: str) -> str:
    num, den = fraction.split("/")
    return num_to_cn(den) + "分之" + num_to_cn(num)


def _percentage_to_cn(percentage: str) -> str:
    return "百分之" + num_to_cn(percentage.strip().strip("%"))


# ---------------------------------------------------------------------------
# dispatcher (Text.normalize): pattern order and first-occurrence
# replacement semantics are behavior, reproduced exactly
# ---------------------------------------------------------------------------

_CURRENCY_UNITS = (
    "((亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)"
)
_QUANTIFIERS = (
    "(匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|"
    "砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|"
    "针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|"
    "毫|厘|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|"
    "纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块|人|抽)"
)

_DATE_RE = re.compile(r"\D+((([089]\d|(19|20)\d{2})年)?(\d{1,2}月(\d{1,2}[日号])?)?)")
_MONEY_RE = re.compile(
    r"\D+((\d+(\.\d+)?)[多余几]?" + _CURRENCY_UNITS + r"(\d" + _CURRENCY_UNITS + r"?)?)"
)
_MOBILE_RE = re.compile(r"\D((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})\D")
_LANDLINE_RE = re.compile(r"\D((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})\D")
_FRACTION_RE = re.compile(r"(\d+/\d+)")
_PERCENT_RE = re.compile(r"(\d+(\.\d+)?%)")
_QUANT_RE = re.compile(r"(\d+(\.\d+)?)[多余几]?" + _QUANTIFIERS)
_DIGIT_RE = re.compile(r"(\d{4,32})")
_CARDINAL_RE = re.compile(r"(\d+(\.\d+)?)")
_LETTER2_RE = re.compile(r"(([a-zA-Z]+)二([a-zA-Z]+))")


def normalize_cn_text(raw_text: str) -> str:
    """Text(raw_text).normalize() equivalent."""
    text = "^" + raw_text + "$"

    for m in _DATE_RE.findall(text):
        text = text.replace(m[0], _date_to_cn(m[0]), 1)
    for m in _MONEY_RE.findall(text):
        text = text.replace(m[0], _money_to_cn(m[0]), 1)
    for m in _MOBILE_RE.findall(text):
        text = text.replace(m[0], _telephone_to_cn(m[0]), 1)
    for m in _LANDLINE_RE.findall(text):
        text = text.replace(m[0], _telephone_to_cn(m[0], fixed=True), 1)
    for m in _FRACTION_RE.findall(text):
        text = text.replace(m, _fraction_to_cn(m), 1)
    text = text.replace("％", "%")
    for m in _PERCENT_RE.findall(text):
        text = text.replace(m[0], _percentage_to_cn(m[0]), 1)
    for m in _QUANT_RE.findall(text):
        text = text.replace(m[0], num_to_cn(m[0]), 1)
    for m in _DIGIT_RE.findall(text):
        text = text.replace(m, digits_to_cn(m), 1)
    for m in _CARDINAL_RE.findall(text):
        text = text.replace(m[0], num_to_cn(m[0]), 1)
    # O2O / B2C style letter-二-letter back-substitution
    for m in _LETTER2_RE.findall(text):
        text = text.replace(m[0], m[1] + "2" + m[2], 1)
    return text.lstrip("^").rstrip("$")
