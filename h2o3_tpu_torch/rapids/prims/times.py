"""Rapids time prims (16) — the port of ``h2o3_tpu/rapids/prims/times.py``
(copied, host numpy and ``zoneinfo``).

Reference: ``water/rapids/ast/prims/time/`` — AsDate Day DayOfWeek GetTimeZone
Hour ListTimeZones Millis Minute Mktime Moment Month Second SetTimeZone Time
Week Year.  TIME columns hold float64 milliseconds since epoch (UTC);
timezone is a process-wide setting like the reference's ParseTime zone
(``_TIME_ZONE``, this module's own: ``setTimeZone`` in the port leaves
the JAX package's zone as it is).
"""

from __future__ import annotations

import datetime as _dt
from typing import Callable

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import map_columns, numeric_data
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val

_TIME_ZONE = "UTC"


def _tz():
    import zoneinfo

    return zoneinfo.ZoneInfo(_TIME_ZONE)


def _field_map(ms: np.ndarray, field: str) -> np.ndarray:
    """Extract a datetime field from ms-since-epoch via numpy datetime64
    (fast path, UTC) or per-element zoneinfo when a zone is set."""
    out = np.full(ms.shape, np.nan)
    ok = ~np.isnan(ms)
    if _TIME_ZONE == "UTC":
        dt = ms[ok].astype("int64").astype("datetime64[ms]")
        Y = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        M = (dt.astype("datetime64[M]").astype(np.int64) % 12) + 1
        D = (dt.astype("datetime64[D]") - dt.astype("datetime64[M]")).astype(np.int64) + 1
        if field == "year":
            out[ok] = Y
        elif field == "month":
            out[ok] = M
        elif field == "day":
            out[ok] = D
        elif field == "dayofweek":
            # 1970-01-01 was Thursday; reference DayOfWeek: 0=Mon..6=Sun
            out[ok] = ((dt.astype("datetime64[D]").astype(np.int64) + 3) % 7)
        elif field == "hour":
            out[ok] = (dt - dt.astype("datetime64[D]")).astype("timedelta64[h]").astype(np.int64)
        elif field == "minute":
            out[ok] = (dt - dt.astype("datetime64[h]")).astype("timedelta64[m]").astype(np.int64)
        elif field == "second":
            out[ok] = (dt - dt.astype("datetime64[m]")).astype("timedelta64[s]").astype(np.int64)
        elif field == "millis":
            out[ok] = (dt - dt.astype("datetime64[s]")).astype("timedelta64[ms]").astype(np.int64)
        elif field == "week":
            iso = [
                _dt.datetime.fromtimestamp(v / 1000.0, _dt.timezone.utc).isocalendar()[1]
                for v in ms[ok]
            ]
            out[ok] = iso
        else:
            raise RapidsError(f"unknown time field {field!r}")
        return out
    tz = _tz()
    for i in np.nonzero(ok)[0]:
        d = _dt.datetime.fromtimestamp(ms[i] / 1000.0, tz)
        out[i] = {
            "year": d.year,
            "month": d.month,
            "day": d.day,
            "dayofweek": d.weekday(),
            "hour": d.hour,
            "minute": d.minute,
            "second": d.second,
            "millis": d.microsecond // 1000,
            "week": d.isocalendar()[1],
        }[field]
    return out


def _timeop(name: str, field: str):
    @prim(name)
    def op(env, args, field=field):
        v = args[0]
        if v.is_frame():
            return Val.frame(map_columns(v.value, lambda a: _field_map(a, field)))
        return Val.num(float(_field_map(np.array([v.as_num()]), field)[0]))

    return op


_timeop("year", "year")
_timeop("month", "month")
_timeop("day", "day")
_timeop("dayOfWeek", "dayofweek")
_timeop("hour", "hour")
_timeop("minute", "minute")
_timeop("second", "second")
_timeop("millis", "millis")
_timeop("week", "week")


@prim("mktime")
def mktime(env, args):
    """(mktime year month day hour minute second msec) — frames or scalars;
    month/day are ZERO-based in rapids (AstMktime)."""
    parts = []
    n = 1
    for v in args:
        if v.is_frame():
            parts.append(numeric_data(v.value.col(0)))
            n = max(n, v.value.nrows)
        else:
            parts.append(np.array([v.as_num()]))
    while len(parts) < 7:
        parts.append(np.zeros(1))
    parts = [np.resize(p, n) for p in parts]
    out = np.empty(n)
    tz = _tz()
    for i in range(n):
        y, mo, d, h, mi, s, ms_ = (parts[j][i] for j in range(7))
        if any(np.isnan(x) for x in (y, mo, d, h, mi, s, ms_)):
            out[i] = np.nan
            continue
        dt = _dt.datetime(
            int(y), int(mo) + 1, int(d) + 1, int(h), int(mi), int(s), int(ms_) * 1000, tzinfo=tz
        )
        out[i] = dt.timestamp() * 1000.0
    if n == 1 and not any(v.is_frame() for v in args):
        return Val.num(float(out[0]))
    return Val.frame(Frame([Column("mktime", out, ColType.TIME)]))


@prim("moment")
def moment(env, args):
    return mktime(env, args)


@prim("as.Date")
def as_date(env, args):
    """(as.Date fr format) — parse STR/CAT to TIME (AstAsDate)."""
    fr = args[0].as_frame()
    fmt = args[1].as_str()
    # translate Joda-ish patterns to strptime
    py_fmt = (
        fmt.replace("yyyy", "%Y").replace("yy", "%y").replace("MM", "%m")
        .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
    )
    from h2o3_tpu_torch.rapids.prims.strings import _str_values

    tz = _tz()
    cols = []
    for c in fr.columns:
        vals = _str_values(c)
        out = np.empty(len(vals))
        for i, v in enumerate(vals):
            if v is None:
                out[i] = np.nan
            else:
                dt = _dt.datetime.strptime(v, py_fmt).replace(tzinfo=tz)
                out[i] = dt.timestamp() * 1000.0
        cols.append(Column(c.name, out, ColType.TIME))
    return Val.frame(Frame(cols))


@prim("time")
def time_(env, args):
    """ms-of-day component."""
    v = args[0]
    fn = lambda a: np.where(np.isnan(a), np.nan, np.mod(a, 86400000.0))
    if v.is_frame():
        return Val.frame(map_columns(v.value, fn))
    return Val.num(float(fn(np.array([v.as_num()]))[0]))


@prim("getTimeZone")
def get_time_zone(env, args):
    return Val.str_(_TIME_ZONE)


@prim("setTimeZone")
def set_time_zone(env, args):
    global _TIME_ZONE
    import zoneinfo

    name = args[0].as_str()
    zoneinfo.ZoneInfo(name)  # validate
    _TIME_ZONE = name
    return Val.str_(name)


@prim("listTimeZones")
def list_time_zones(env, args):
    import zoneinfo

    zones = sorted(zoneinfo.available_timezones())
    return Val.frame(Frame([Column("timezones", np.array(zones, dtype=object), ColType.STR)]))
