"""Time-zone rules as device arrays.

Reference analog: ``spi/type/TimestampWithTimeZoneType.java`` +
``spi/type/DateTimeEncoding.java`` (packed millis | zoneKey) and the Joda
zone rules the engine evaluates per value on the JVM.

TPU redesign: a TIMESTAMP WITH TIME ZONE column stores **UTC micros as
int64 on device** (instant semantics — comparison/join/group-by are plain
int64 ops, exactly the reference's "order by UTC instant" contract) and
carries its zone as *column metadata* on the type. Zone-rule evaluation
(wall-clock conversion for casts, EXTRACT, formatting) becomes a
vectorized ``searchsorted`` over the zone's DST transition table uploaded
once per zone — no per-value host calls, no scalar loops.

Transition tables come from parsing the binary TZif files under
``/usr/share/zoneinfo`` (RFC 8536; ``zoneinfo.ZoneInfo`` hides them), and
fixed offsets (``+05:30``) are handled directly.
"""

from __future__ import annotations

import os
import re
import struct
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

TZDIR = "/usr/share/zoneinfo"

_FIXED_RE = re.compile(r"^(?:UTC)?([+-])(\d{1,2}):?(\d{2})$")

#: sentinel first transition: effectively -inf
_NEG_INF = np.int64(-(1 << 62))


def canonical_zone(zone: str) -> str:
    z = zone.strip()
    if z.upper() in ("UTC", "Z", "UT", "GMT", "+00:00", "-00:00"):
        return "UTC"
    return z


def parse_fixed_offset_micros(zone: str) -> Optional[int]:
    """``+HH:MM`` / ``-HH:MM`` (optionally ``UTC``-prefixed) -> micros,
    or None if the zone is not a fixed offset."""
    z = canonical_zone(zone)
    if z == "UTC":
        return 0
    m = _FIXED_RE.match(z)
    if m is None:
        return None
    sign = 1 if m.group(1) == "+" else -1
    return sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60) * 1_000_000


def _parse_tzif(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """RFC 8536 TZif -> (transition instants in UTC seconds, utc offsets
    in seconds applying from each instant). First entry is the -inf
    sentinel carrying the pre-first-transition offset."""
    with open(path, "rb") as f:
        data = f.read()

    def header(off):
        magic, version = data[off:off + 4], data[off + 4:off + 5]
        if magic != b"TZif":
            raise ValueError(f"not a TZif file: {path}")
        counts = struct.unpack(">6I", data[off + 20:off + 44])
        return version, counts  # isutcnt isstdcnt leapcnt timecnt typecnt charcnt

    version, counts = header(0)
    isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = counts
    v1_len = 44 + timecnt * 5 + typecnt * 6 + charcnt + leapcnt * 8 \
        + isstdcnt + isutcnt
    has_footer = version >= b"2"
    if has_footer:
        # second, 64-bit block follows the v1 block
        off = v1_len
        version, counts = header(off)
        isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = counts
        body = off + 44
        tsize = 8
        tfmt = ">%dq"
    else:
        body = 44
        tsize = 4
        tfmt = ">%dl"
    trans = np.array(struct.unpack(tfmt % timecnt,
                                   data[body:body + timecnt * tsize]),
                     dtype=np.int64) if timecnt else np.zeros(0, np.int64)
    p = body + timecnt * tsize
    idx = np.frombuffer(data[p:p + timecnt], dtype=np.uint8)
    p += timecnt
    ttinfo = [struct.unpack(">lBB", data[p + i * 6:p + i * 6 + 6])
              for i in range(typecnt)]
    offsets = np.array([t[0] for t in ttinfo], dtype=np.int64)
    isdst = [t[1] for t in ttinfo]
    # pre-first-transition offset: first non-DST type (RFC 8536 §3.2)
    first = next((i for i in range(typecnt) if not isdst[i]), 0)
    out_trans = np.concatenate([[_NEG_INF], trans])
    out_offs = np.concatenate([[offsets[first]],
                               offsets[idx] if timecnt
                               else np.zeros(0, np.int64)])
    if has_footer:
        # v2+ footer: a POSIX TZ string giving the rule for instants
        # past the last tabulated transition (RFC 8536 §3.3). Without
        # it the last offset freezes (~2037 for fat tzdata).
        parts = data.rsplit(b"\n", 2)
        tzstr = parts[1].decode("ascii", "replace") if len(parts) == 3 \
            else ""
        ext = _footer_transitions(tzstr, out_trans, out_offs)
        if ext is not None:
            out_trans, out_offs = ext
    return out_trans, out_offs


#: how far the footer rule is unrolled into explicit transitions
_FOOTER_END_YEAR = 2100

_TZNAME = r"(?:[A-Za-z]{3,}|<[A-Za-z0-9+-]+>)"
_TZOFF = r"([+-]?\d{1,3}(?::\d{1,2}(?::\d{1,2})?)?)"
_POSIX_TZ_RE = re.compile(
    rf"^{_TZNAME}{_TZOFF}(?:({_TZNAME}){_TZOFF}?(?:,([^,]+),([^,]+))?)?$")


def _hms_seconds(s: str) -> int:
    sign = -1 if s.startswith("-") else 1
    parts = s.lstrip("+-").split(":")
    sec = 0
    for unit, v in zip((3600, 60, 1), parts):
        sec += unit * int(v)
    return sign * sec


def _rule_instant(rule: str, year: int) -> int:
    """Local epoch-seconds (as if UTC) of one POSIX transition rule in
    ``year``: Mm.w.d, Jn, or n, with optional /time (default 02:00;
    extended range ±167h allowed)."""
    import calendar
    import datetime

    time_s = 2 * 3600
    if "/" in rule:
        rule, t = rule.split("/", 1)
        time_s = _hms_seconds(t)
    if rule.startswith("M"):
        m, w, d = (int(x) for x in rule[1:].split("."))
        first_wd = (datetime.date(year, m, 1).weekday() + 1) % 7  # Sun=0
        day = 1 + (d - first_wd) % 7 + (w - 1) * 7
        while day > calendar.monthrange(year, m)[1]:
            day -= 7
        date = datetime.date(year, m, day)
    elif rule.startswith("J"):
        n = int(rule[1:])  # 1..365, Feb 29 never counted
        date = datetime.date(year, 1, 1) + datetime.timedelta(n - 1)
        if calendar.isleap(year) and n >= 60:
            date += datetime.timedelta(1)
    else:
        n = int(rule)      # 0..365, Feb 29 counted
        date = datetime.date(year, 1, 1) + datetime.timedelta(n)
    epoch_day = (date - datetime.date(1970, 1, 1)).days
    return epoch_day * 86400 + time_s


def _footer_transitions(tzstr: str, trans: np.ndarray,
                        offs: np.ndarray):
    """Extend (trans, offs) with transitions synthesized from the footer
    POSIX TZ string through ``_FOOTER_END_YEAR``, or None if the string
    is absent/unsupported/DST-free (the frozen last offset is then
    already correct for a constant-offset tail)."""
    import datetime

    m = _POSIX_TZ_RE.match(tzstr.strip())
    if m is None:
        return None
    std_s, dst_name, dst_s, start_rule, end_rule = m.groups()
    if not dst_name or not start_rule:
        return None  # no DST tail: constant offset, nothing to extend
    std_off = -_hms_seconds(std_s)          # POSIX: positive = west
    dst_off = (-_hms_seconds(dst_s)) if dst_s else std_off + 3600
    last = int(trans[-1]) if len(trans) > 1 else 0
    y0 = datetime.datetime.fromtimestamp(
        max(last, 0), datetime.timezone.utc).year
    new = []
    for year in range(y0, _FOOTER_END_YEAR + 1):
        try:
            to_dst = _rule_instant(start_rule, year) - std_off
            to_std = _rule_instant(end_rule, year) - dst_off
        except (ValueError, IndexError):
            return None
        new.extend([(to_dst, dst_off), (to_std, std_off)])
    new = [(t, o) for (t, o) in sorted(new) if t > last]
    if not new:
        return None
    return (np.concatenate([trans, np.array([t for t, _ in new],
                                            dtype=np.int64)]),
            np.concatenate([offs, np.array([o for _, o in new],
                                           dtype=np.int64)]))


@lru_cache(maxsize=64)
def utc_offset_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_us, offsets_us): ``offsets_us[i]`` is the UTC offset
    for instants in ``[transitions_us[i], transitions_us[i+1])``."""
    z = canonical_zone(zone)
    fixed = parse_fixed_offset_micros(z)
    if fixed is not None:
        return (np.array([_NEG_INF], dtype=np.int64),
                np.array([fixed], dtype=np.int64))
    path = os.path.join(TZDIR, z)
    if not os.path.exists(path):
        raise ValueError(f"unknown time zone: {zone}")
    trans_s, offs_s = _parse_tzif(path)
    trans = np.where(trans_s == _NEG_INF, _NEG_INF, trans_s * 1_000_000)
    return trans.astype(np.int64), (offs_s * 1_000_000).astype(np.int64)


@lru_cache(maxsize=64)
def wall_offset_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """Like utc_offset_table but keyed by *wall* time. Entry i applies to
    wall instants ``>= trans_utc[i] + max(offset[i], offset[i-1])``:
    ambiguous wall times in a fall-back overlap stay in entry i-1 (the
    EARLIER, pre-transition offset — the reference's Joda
    ``convertLocalToUTC`` pick), and nonexistent spring-forward gap
    times also resolve with the pre-transition offset (clock carried
    forward across the gap)."""
    trans, offs = utc_offset_table(zone)
    prev = np.concatenate([offs[:1], offs[:-1]])
    wall = np.where(trans == _NEG_INF, _NEG_INF,
                    trans + np.maximum(offs, prev))
    # safety: keep starts monotone for searchsorted
    wall = np.maximum.accumulate(wall)
    return wall.astype(np.int64), offs


def utc_to_wall_np(vals: np.ndarray, zone: str) -> np.ndarray:
    trans, offs = utc_offset_table(zone)
    i = np.searchsorted(trans, vals, side="right") - 1
    return vals + offs[np.clip(i, 0, len(offs) - 1)]


def wall_to_utc_host(wall_micros: int, zone: str) -> int:
    """Host scalar wall-clock micros in ``zone`` -> UTC micros (literal
    analysis and other one-off host conversions)."""
    wtab, woffs = wall_offset_table(zone)
    i = int(np.searchsorted(wtab, wall_micros, side="right")) - 1
    return wall_micros - int(woffs[max(0, min(i, len(woffs) - 1))])


def offset_at(zone: str, utc_micros: int) -> int:
    trans, offs = utc_offset_table(zone)
    i = int(np.searchsorted(trans, utc_micros, side="right")) - 1
    return int(offs[max(0, min(i, len(offs) - 1))])


# -------------------------------------------------------------- device ----

def _table_lookup(vals, table, offs):
    import torch

    t = torch.as_tensor(table, dtype=torch.int64, device=vals.device)
    o = torch.as_tensor(offs, dtype=torch.int64, device=vals.device)
    i = torch.clamp(torch.searchsorted(t, vals, right=True) - 1, 0,
                    len(offs) - 1)
    return o[i]


def device_utc_to_wall(vals, zone: str):
    """torch int64 UTC micros -> wall micros in ``zone`` (device op)."""
    trans, offs = utc_offset_table(zone)
    if len(offs) == 1:  # fixed offset: no table needed
        return vals + int(offs[0])
    return vals + _table_lookup(vals, trans, offs)


def device_wall_to_utc(vals, zone: str):
    """torch int64 wall micros in ``zone`` -> UTC micros (device op)."""
    wall, offs = wall_offset_table(zone)
    if len(offs) == 1:
        return vals - int(offs[0])
    return vals - _table_lookup(vals, wall, offs)
