"""Typed sensors with status (counterpart of ``dpdk_dc_sand_tpu/control/sensors.py``).

KATCP semantics (SURVEY.md §5.5): every node exposes named, typed,
timestamped sensors with a status; aggregators watch, rename, and
re-publish them (corr3_servlet.py:14-64). Sensors double as the health
channel (``device-status``, fake_node.py:29-30).
"""

from __future__ import annotations

import enum
import time
from typing import Callable, Dict, Iterator, List, Optional


class Status(enum.Enum):
    UNKNOWN = "unknown"
    NOMINAL = "nominal"
    WARN = "warn"
    ERROR = "error"
    FAILURE = "failure"
    UNREACHABLE = "unreachable"
    INACTIVE = "inactive"


_TYPES = {"integer": int, "float": float, "boolean": bool, "string": str,
          "discrete": str}


class Sensor:
    """One named, typed, timestamped observable value."""

    def __init__(
        self,
        name: str,
        description: str = "",
        units: str = "",
        stype: str = "string",
        initial=None,
        status: Status = Status.UNKNOWN,
    ) -> None:
        if stype not in _TYPES:
            raise ValueError(f"unknown sensor type {stype!r}")
        self.name = name
        self.description = description
        self.units = units
        self.stype = stype
        self._value = initial if initial is not None else _TYPES[stype]()
        self._status = status
        self._timestamp = time.time()
        self._observers: List[Callable[["Sensor"], None]] = []

    @property
    def value(self):
        return self._value

    @property
    def status(self) -> Status:
        return self._status

    @property
    def timestamp(self) -> float:
        return self._timestamp

    def set(
        self,
        value,
        status: Status = Status.NOMINAL,
        timestamp: Optional[float] = None,
    ) -> None:
        self._value = _TYPES[self.stype](value)
        self._status = status
        self._timestamp = timestamp if timestamp is not None else time.time()
        for cb in list(self._observers):
            cb(self)

    def observe(self, callback: Callable[["Sensor"], None]) -> None:
        self._observers.append(callback)

    def unobserve(self, callback: Callable[["Sensor"], None]) -> None:
        if callback in self._observers:
            self._observers.remove(callback)

    def format_value(self) -> str:
        if self.stype == "boolean":
            return "1" if self._value else "0"
        return str(self._value)


class SensorSet:
    """Named collection with add/remove notification (the server registry)."""

    def __init__(self) -> None:
        self._sensors: Dict[str, Sensor] = {}
        self._listeners: List[Callable[[str, Sensor], None]] = []

    def add(self, sensor: Sensor) -> Sensor:
        self._sensors[sensor.name] = sensor
        for cb in list(self._listeners):
            cb("added", sensor)
        return sensor

    def remove(self, name: str) -> Optional[Sensor]:
        s = self._sensors.pop(name, None)
        if s is not None:
            for cb in list(self._listeners):
                cb("removed", s)
        return s

    def on_change(self, callback: Callable[[str, Sensor], None]) -> None:
        self._listeners.append(callback)

    def __getitem__(self, name: str) -> Sensor:
        return self._sensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._sensors

    def __iter__(self) -> Iterator[Sensor]:
        return iter(self._sensors.values())

    def __len__(self) -> int:
        return len(self._sensors)
