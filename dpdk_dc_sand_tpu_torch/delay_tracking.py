"""Delay-tracking requirements calculator (counterpart of ``dpdk_dc_sand_tpu/delay_tracking.py``).

Behavioural parity with
``delay_tracking/delay_tracking_requirements_calculator.py``: from antenna
geographic coordinates, derive the longest baseline, the maximum delay the
system must compensate (3× the baseline light-travel time, accounting for a
virtual reference antenna and PPS cable-length margin, reference
lines 145-171), and the delay rate-of-change envelope for a source moving
90° in 6 h evaluated at 15° and 90° elevation (lines 173-191).

The reference uses geopy's geodesic distance but notes the chord is what is
physically wanted (lines 82-85); with no geopy in this environment we
compute the WGS84 ECEF chord directly — which is both dependency-free and
the more correct geometry.
"""

from __future__ import annotations

import argparse
import csv
import itertools
from typing import Dict, Tuple

import numpy as np

SPEED_OF_LIGHT = 299792458.0  # m/s (scipy.constants.c)

# WGS84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def geodetic_to_ecef(lat_deg: float, lon_deg: float, height_m: float = 0.0):
    """WGS84 geodetic → Earth-centred Earth-fixed cartesian (metres)."""
    lat = np.radians(float(lat_deg))
    lon = np.radians(float(lon_deg))
    n = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * np.sin(lat) ** 2)
    x = (n + height_m) * np.cos(lat) * np.cos(lon)
    y = (n + height_m) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - _WGS84_E2) + height_m) * np.sin(lat)
    return np.array([x, y, z])


def chord_distance_km(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    """Straight-line (chord) distance between two (lat, lon) points in km."""
    return float(
        np.linalg.norm(geodetic_to_ecef(*a) - geodetic_to_ecef(*b)) / 1000.0
    )


def get_coordinates_from_csv(
    path_to_csv: str,
    delimiter: str = ",",
    col_labels: bool = True,
    latitude_first: bool = False,
) -> Dict[str, Tuple[float, float]]:
    """Read ``name, lon, lat`` (or ``name, lat, lon``) rows into a dict.

    Same CSV contract as the reference (lines 26-56).
    """
    rows = []
    with open(path_to_csv, newline="") as f:
        for row in csv.reader(f, delimiter=delimiter):
            if row:
                rows.append(row)
    if col_labels and rows:
        rows.pop(0)
    if latitude_first:
        return {r[0]: (float(r[1]), float(r[2])) for r in rows}
    return {r[0]: (float(r[2]), float(r[1])) for r in rows}


def calculate_baselines(
    antenna_pos_coords: Dict[str, Tuple[float, float]]
) -> Dict[Tuple[str, str], float]:
    """All-pairs baseline lengths in km (reference lines 59-87)."""
    return {
        (a, b): chord_distance_km(antenna_pos_coords[a], antenna_pos_coords[b])
        for a, b in itertools.product(antenna_pos_coords, repeat=2)
    }


def find_longest_baseline(
    baselines: Dict[Tuple[str, str], float]
) -> Tuple[Tuple[str, str], float]:
    """Longest baseline by value.

    (The reference's ``max(baselines, key=lambda x: x[1])`` sorts by the
    second *antenna name* — an apparent bug, reference line 98; we take the
    maximum by baseline length as documented.)
    """
    pair = max(baselines, key=baselines.get)
    return pair, baselines[pair]


def calculate_delay_from_source_elevation(
    baseline: float, source_elevation_degrees: float
) -> float:
    """Geometric delay in seconds for a source at the given elevation.

    ``delay = baseline · cos(elevation) / c`` (reference lines 104-120);
    ``baseline`` in metres.
    """
    if not 0.0 <= source_elevation_degrees <= 90.0:
        raise ValueError("source_elevation_degrees needs to be within: 0<=x<=90")
    return baseline * np.cos(np.radians(source_elevation_degrees)) / SPEED_OF_LIGHT


def calculate_delay_rate_of_change(
    baseline: float,
    elevation: float,
    elevation_change_per_second: float,
    max_or_min: str,
) -> float:
    """|Δdelay| in ns per second of source motion (reference lines 123-142)."""
    d1 = calculate_delay_from_source_elevation(baseline, elevation)
    if max_or_min == "max":
        d2 = calculate_delay_from_source_elevation(
            baseline, elevation - elevation_change_per_second
        )
    else:
        d2 = calculate_delay_from_source_elevation(
            baseline, elevation + elevation_change_per_second
        )
    return abs(d2 - d1) * 1e9


def calculate_delay_tracking_requirements(longest_baseline: float) -> dict:
    """Delay-tracking envelope for a longest baseline given in km.

    Max compensation = 3 × baseline/c: ×2 for the virtual reference antenna
    plus ~×1 for PPS cable-length differences (reference lines 152-170);
    rate range from a 90°-per-6 h source at 15°/90° elevation (lines 172-193).
    """
    longest_baseline_m = longest_baseline * 1000.0
    max_coarse_delay_s = 3.0 * longest_baseline_m / SPEED_OF_LIGHT
    elevation_change_per_second = 90.0 / (3600.0 * 6.0)
    elevation = {"min": 15.0, "max": 90.0}
    range_of_rate_of_change = {
        k: calculate_delay_rate_of_change(
            baseline=longest_baseline_m,
            elevation=v,
            elevation_change_per_second=elevation_change_per_second,
            max_or_min=k,
        )
        for k, v in elevation.items()
    }
    return {
        "longest_baseline_km": longest_baseline_m / 1000.0,
        "max_coarse_delay_us": max_coarse_delay_s * 1e6,
        "range_of_rate_of_change_of_delay_ns_s": range_of_rate_of_change,
    }


def max_coarse_delay_samples(longest_baseline_km: float, adc_sample_rate: float) -> int:
    """Delay envelope expressed in ADC samples — sizes the coarse-delay FIFO."""
    reqs = calculate_delay_tracking_requirements(longest_baseline_km)
    return int(np.ceil(reqs["max_coarse_delay_us"] * 1e-6 * adc_sample_rate))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ant_pos", type=str, help="csv of antenna positions")
    parser.add_argument("-d", dest="delimiter", type=str, default=",")
    parser.add_argument("-l", dest="lat_first", action="store_true")
    parser.add_argument("-n", dest="no_col_labels", action="store_true")
    args = parser.parse_args(argv)

    coords = get_coordinates_from_csv(
        args.ant_pos,
        delimiter=args.delimiter,
        col_labels=not args.no_col_labels,
        latitude_first=args.lat_first,
    )
    baselines = calculate_baselines(coords)
    pair, longest_km = find_longest_baseline(baselines)
    reqs = calculate_delay_tracking_requirements(longest_km)

    print("=" * 64)
    print("Correlator Delay Tracking Requirements")
    print("=" * 64)
    print(f"Longest Baseline: {longest_km:.2f} km")
    print(f"Longest Baseline Antenna Pair: {pair}")
    print(f"Maximum Delay Compensation: {reqs['max_coarse_delay_us']:.2f} us")
    rr = reqs["range_of_rate_of_change_of_delay_ns_s"]
    print(
        "Range of rate of change of delay: "
        f"<={rr['min']:.2f} ns/s to >= {rr['max']:.2f} ns/s"
    )
    print("=" * 64)


if __name__ == "__main__":
    main()
