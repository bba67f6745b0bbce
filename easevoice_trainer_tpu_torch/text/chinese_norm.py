"""Chinese text normalization: NSW (non-standard words) -> spoken hanzi.

Reference-grade rule coverage (reference: src/easevoice/text/chinese_norm/
{num.py,chronology.py,phonecode.py,quantifier.py,text_normlization.py},
PaddleSpeech-lineage rules): dates (年月日 and YY-MM-DD), clock times and
time ranges (with 半 for :30), temperatures, measure units, math
expressions (+-×÷= chains, superscript powers), fractions, percentages,
mobile/landline/400 phone numbers (digit reading, 1 -> 幺), numeric ranges,
negative numbers, decimals, quantifier-aware cardinals (两 before measure
words), digit strings, fullwidth->halfwidth folding, traditional->simplified
conversion (vendored table at data/trad2simp.json), greek letters and list
bullets.

The rule *inventory* (regex shapes, measure-word sets, reading tables) is
behavior-compatibility data shared with the reference; the implementation
is ours.
"""
from __future__ import annotations

import json
import os
import re
import string
from functools import lru_cache
from typing import List

# ---------------------------------------------------------------------------
# cardinal / digit verbalization (num.py:244-307 semantics)
# ---------------------------------------------------------------------------

DIGITS = {str(i): ch for i, ch in enumerate("零一二三四五六七八九")}
UNITS = {1: "十", 2: "百", 3: "千", 4: "万", 8: "亿"}
_UNIT_POWERS = (8, 4, 3, 2, 1)

COM_QUANTIFIERS = (
    "(处|台|架|枚|趟|幅|平|方|堵|间|床|株|批|项|例|列|篇|栋|注|亩|封|艘|把|"
    "目|套|段|人|所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|"
    "支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|"
    "坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|"
    "位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|"
    "(千|毫|微)克|毫|厘|(公)分|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|"
    "米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|盒|杯|钟|斛|锅|簋|篮|盘|桶|"
    "罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|小时|"
    "旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|"
    "面|片|张|颗|块|元|(亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|美|)元|"
    "(亿|千万|百万|万|千|百|十|)吨|(亿|千万|百万|万|千|百|)块|角|毛|分)")


def _get_value(value_string: str, use_zero: bool = True) -> List[str]:
    stripped = value_string.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        if use_zero and len(stripped) < len(value_string):
            return [DIGITS["0"], DIGITS[stripped]]
        return [DIGITS[stripped]]
    largest = next(p for p in _UNIT_POWERS if p < len(stripped))
    head, tail = value_string[:-largest], value_string[-largest:]
    return _get_value(head) + [UNITS[largest]] + _get_value(tail)


def verbalize_cardinal(value_string: str) -> str:
    if not value_string:
        return ""
    value_string = value_string.lstrip("0")
    if not value_string:
        return DIGITS["0"]
    symbols = _get_value(value_string)
    # 一十X reads 十X
    if len(symbols) >= 2 and symbols[0] == DIGITS["1"] \
            and symbols[1] == UNITS[1]:
        symbols = symbols[1:]
    return "".join(symbols)


def verbalize_digit(value_string: str, alt_one: bool = False) -> str:
    result = "".join(DIGITS[d] for d in value_string)
    return result.replace("一", "幺") if alt_one else result


def num2str(value_string: str) -> str:
    integer, _, decimal = value_string.partition(".")
    result = verbalize_cardinal(integer)
    decimal = decimal.rstrip("0")
    if decimal:
        result = result or "零"
        result += "点" + verbalize_digit(decimal)
    return result


# backwards-compatible helpers (used by english.py / tests)
def num_to_hanzi(n: int) -> str:
    return ("负" if n < 0 else "") + num2str(str(abs(n)))


def digits_to_hanzi(s: str) -> str:
    return verbalize_digit(s, alt_one=True)


# ---------------------------------------------------------------------------
# rules (regex shapes follow the reference for behavior parity)
# ---------------------------------------------------------------------------

RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")
RE_INTEGER = re.compile(r"(-)(\d+)")
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")
RE_DECIMAL_NUM = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")
RE_POSITIVE_QUANTIFIERS = re.compile(r"(\d+)([多余几\+])?" + COM_QUANTIFIERS)
RE_RANGE = re.compile(r"""
    (?<![\d\+\-\×÷=])
    ((-?)((\d+)(\.\d+)?))
    [-~]
    ((-?)((\d+)(\.\d+)?))
    (?![\d\+\-\×÷=])
    """, re.VERBOSE)
_MEASURES = ("%|°C|℃|度|摄氏度|cm2|cm²|cm3|cm³|cm|db|ds|kg|km|m2|m²|m³|m3|"
             "ml|m|mm|s")
RE_TO_RANGE = re.compile(
    r"((-?)((\d+)(\.\d+)?)|(\.(\d+)))"
    rf"({_MEASURES})[~]((-?)((\d+)(\.\d+)?)|(\.(\d+)))({_MEASURES})")
RE_ASMD = re.compile(
    r"((-?)((\d+)(\.\d+)?[⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*)|(\.\d+[⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*)"
    r"|([A-Za-z][⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*))([\+\-\×÷=])"
    r"((-?)((\d+)(\.\d+)?[⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*)|(\.\d+[⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*)"
    r"|([A-Za-z][⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]*))")
RE_POWER = re.compile(r"[⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ]+")

RE_TIME = re.compile(r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"(~|-)"
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_DATE = re.compile(
    r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?"
    r"(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?")
RE_DATE2 = re.compile(
    r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")

RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)")
RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})(?!\d)")
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")

RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")
MEASURE_DICT = {
    "cm2": "平方厘米", "cm²": "平方厘米", "cm3": "立方厘米", "cm³": "立方厘米",
    "cm": "厘米", "db": "分贝", "ds": "毫秒", "kg": "千克", "km": "千米",
    "m2": "平方米", "m²": "平方米", "m³": "立方米", "m3": "立方米",
    "ml": "毫升", "m": "米", "mm": "毫米", "s": "秒",
}

_ASMD_MAP = {"+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等于"}
_POWER_MAP = {"⁰": "0", "¹": "1", "²": "2", "³": "3", "⁴": "4", "⁵": "5",
              "⁶": "6", "⁷": "7", "⁸": "8", "⁹": "9", "ˣ": "x", "ʸ": "y",
              "ⁿ": "n"}

_F2H_ASCII = {ord(c) + 65248: ord(c) for c in string.ascii_letters}
_F2H_DIGITS = {ord(c) + 65248: ord(c) for c in string.digits}
_F2H_SPACE = {0x3000: ord(" ")}

_POST_MAP = {
    "/": "每", "①": "一", "②": "二", "③": "三", "④": "四", "⑤": "五",
    "⑥": "六", "⑦": "七", "⑧": "八", "⑨": "九", "⑩": "十",
    "α": "阿尔法", "β": "贝塔", "γ": "伽玛", "Γ": "伽玛", "δ": "德尔塔",
    "Δ": "德尔塔", "ε": "艾普西龙", "ζ": "捷塔", "η": "依塔", "θ": "西塔",
    "Θ": "西塔", "ι": "艾欧塔", "κ": "喀帕", "λ": "拉姆达", "Λ": "拉姆达",
    "μ": "缪", "ν": "拗", "ξ": "克西", "Ξ": "克西", "ο": "欧米克伦",
    "π": "派", "Π": "派", "ρ": "肉", "ς": "西格玛", "Σ": "西格玛",
    "σ": "西格玛", "τ": "套", "υ": "宇普西龙", "φ": "服艾", "Φ": "服艾",
    "χ": "器", "ψ": "普赛", "Ψ": "普赛", "ω": "欧米伽", "Ω": "欧米伽",
    "+": "加", "=": "等",
}


@lru_cache(maxsize=1)
def trad2simp_table() -> dict:
    path = os.path.join(os.path.dirname(__file__), "data", "trad2simp.json")
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf8") as f:
        return {ord(k): v for k, v in json.load(f).items()}


def tranditional_to_simplified(text: str) -> str:
    return text.translate(trad2simp_table())


# -- replacers ---------------------------------------------------------------


def _replace_frac(m) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(3))}分之{num2str(m.group(2))}"


def _replace_percentage(m) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}百分之{num2str(m.group(2))}"


def _replace_negative_num(m) -> str:
    return ("负" if m.group(1) else "") + num2str(m.group(2))


def _replace_default_num(m) -> str:
    return verbalize_digit(m.group(0), alt_one=True)


def _replace_asmd(m) -> str:
    return m.group(1) + _ASMD_MAP[m.group(8)] + m.group(9)


def _replace_power(m) -> str:
    return "的" + "".join(_POWER_MAP[c] for c in m.group(0)) + "次方"


def _replace_number(m) -> str:
    pure_decimal = m.group(5)
    if pure_decimal:
        return num2str(pure_decimal)
    sign = "负" if m.group(1) else ""
    return sign + num2str(m.group(2))


def _replace_positive_quantifier(m) -> str:
    number, extra, quant = m.group(1), m.group(2), m.group(3)
    extra = "多" if extra == "+" else (extra or "")
    number = num2str(number)
    if number == "二":
        number = "两"
    return f"{number}{extra}{quant}"


def _replace_range(m) -> str:
    first = RE_NUMBER.sub(_replace_number, m.group(1))
    second = RE_NUMBER.sub(_replace_number, m.group(6))
    return f"{first}到{second}"


def _replace_to_range(m) -> str:
    return m.group(0).replace("~", "至")


def _time_num2str(num_string: str) -> str:
    result = num2str(num_string.lstrip("0"))
    if num_string.startswith("0"):
        result = DIGITS["0"] + result
    return result


def _replace_time(m) -> str:
    is_range = len(m.groups()) > 5
    hour, minute, second = m.group(1), m.group(2), m.group(4)
    result = f"{num2str(hour)}点"
    if minute.lstrip("0"):
        result += "半" if int(minute) == 30 else f"{_time_num2str(minute)}分"
    if second and second.lstrip("0"):
        result += f"{_time_num2str(second)}秒"
    if is_range:
        hour2, minute2, second2 = m.group(6), m.group(7), m.group(9)
        result += f"至{num2str(hour2)}点"
        if minute2.lstrip("0"):
            result += ("半" if int(minute) == 30
                       else f"{_time_num2str(minute2)}分")
        if second2 and second2.lstrip("0"):
            result += f"{_time_num2str(second2)}秒"
    return result


def _replace_date(m) -> str:
    year, month, day = m.group(1), m.group(3), m.group(5)
    result = ""
    if year:
        result += f"{verbalize_digit(year)}年"
    if month:
        result += f"{verbalize_cardinal(month)}月"
    if day:
        result += f"{verbalize_cardinal(day)}{m.group(9)}"
    return result


def _replace_date2(m) -> str:
    year, month, day = m.group(1), m.group(3), m.group(4)
    result = ""
    if year:
        result += f"{verbalize_digit(year)}年"
    if month:
        result += f"{verbalize_cardinal(month)}月"
    if day:
        result += f"{verbalize_cardinal(day)}日"
    return result


def _phone2str(phone: str, mobile: bool = True) -> str:
    parts = phone.strip("+").split() if mobile else phone.split("-")
    return "，".join(verbalize_digit(p, alt_one=True) for p in parts)


def _replace_phone(m) -> str:
    return _phone2str(m.group(0), mobile=False)


def _replace_mobile(m) -> str:
    return _phone2str(m.group(0))


def _replace_temperature(m) -> str:
    sign = "零下" if m.group(1) else ""
    unit = "摄氏度" if m.group(4) == "摄氏度" else "度"
    return f"{sign}{num2str(m.group(2))}{unit}"


def _replace_measure(sentence: str) -> str:
    for notation, reading in MEASURE_DICT.items():
        if notation in sentence:
            sentence = sentence.replace(notation, reading)
    return sentence


def _post_replace(sentence: str) -> str:
    for src, dst in _POST_MAP.items():
        sentence = sentence.replace(src, dst)
    sentence = sentence.replace("-", "减")
    sentence = sentence.replace("×", "乘")
    sentence = sentence.replace("÷", "除")
    return re.sub(r"[-——《》【】<=>{}()（）#&@“”^_|\\]", "", sentence)


def normalize_sentence(sentence: str) -> str:
    """Full NSW verbalization of one sentence (text_normlization.py:128-166
    rule order)."""
    sentence = tranditional_to_simplified(sentence)
    sentence = sentence.translate(_F2H_ASCII).translate(
        _F2H_DIGITS).translate(_F2H_SPACE)

    sentence = RE_DATE.sub(_replace_date, sentence)
    sentence = RE_DATE2.sub(_replace_date2, sentence)
    sentence = RE_TIME_RANGE.sub(_replace_time, sentence)
    sentence = RE_TIME.sub(_replace_time, sentence)
    sentence = RE_TO_RANGE.sub(_replace_to_range, sentence)
    sentence = RE_TEMPERATURE.sub(_replace_temperature, sentence)
    sentence = _replace_measure(sentence)
    while RE_ASMD.search(sentence):
        sentence = RE_ASMD.sub(_replace_asmd, sentence)
    sentence = RE_POWER.sub(_replace_power, sentence)
    sentence = RE_FRAC.sub(_replace_frac, sentence)
    sentence = RE_PERCENTAGE.sub(_replace_percentage, sentence)
    sentence = RE_MOBILE_PHONE.sub(_replace_mobile, sentence)
    sentence = RE_TELEPHONE.sub(_replace_phone, sentence)
    sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(_replace_phone, sentence)
    sentence = RE_RANGE.sub(_replace_range, sentence)
    sentence = RE_INTEGER.sub(_replace_negative_num, sentence)
    sentence = RE_DECIMAL_NUM.sub(_replace_number, sentence)
    sentence = RE_POSITIVE_QUANTIFIERS.sub(_replace_positive_quantifier,
                                           sentence)
    sentence = RE_DEFAULT_NUM.sub(_replace_default_num, sentence)
    sentence = RE_NUMBER.sub(_replace_number, sentence)
    return _post_replace(sentence)


class TextNormalizer:
    """Sentence splitter + per-sentence normalization (reference API)."""

    SENTENCE_SPLITOR = re.compile(r"([：、，；。？！,;?!][”’]?)")

    def _split(self, text: str, lang: str = "zh") -> List[str]:
        if lang == "zh":
            text = text.replace(" ", "")
            text = re.sub(r"[——《》【】<>{}()（）#&@“”^_|\\]", "", text)
        text = self.SENTENCE_SPLITOR.sub(r"\1\n", text).strip()
        return [s.strip() for s in re.split(r"\n+", text)]

    def normalize(self, text: str) -> List[str]:
        return [normalize_sentence(s) for s in self._split(text)] or [""]
