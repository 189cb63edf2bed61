"""Celestial frame rotations and proper-motion transforms as virtual
columns: ``df.astro`` (vaex_tpu/astro.py).

Every transform is an expression rewrite over device functions, so the
rotation runs per tile in the pass that reads it.  All frames assume
equinox J2000.
"""

from __future__ import annotations

import math

import numpy as np

from .dataframe import register_dataframe_accessor

# J2000 rotation matrices (equatorial <-> ecliptic / galactic); the same
# published constants vaex-astro carries (transformations.py:7-16)
FRAME_MATRICES = {
    "eq2ecl": [[0.9999999999999928, 1.1102233723050031e-07, 4.411803426976324e-08],
               [-1.1941015020086788e-07, 0.9174821814419274, 0.39777688059582816],
               [3.684608657254395e-09, -0.39777688059583055, 0.9174821814419342]],
    "eq2gal": [[-0.05487553939574265, -0.8734371047275962, -0.48383499177002515],
               [0.49410945362774394, -0.4448295942975751, 0.7469822486998918],
               [-0.8676661356833737, -0.19807638961301982, 0.45598379452141985]],
    "gal2eq": [[-0.0548756577126198, 0.4941094371971076, -0.8676661375571625],
               [-0.873437051955779, -0.44482972122205366, -0.19807633727507046],
               [-0.48383507361641837, 0.7469821839845096, 0.45598381369115243]],
}

# proper motion to transverse velocity: 1 mas/yr at 1 kpc = 4.74057 km/s
K_PM = 4.74057


@register_dataframe_accessor("astro")
class DataFrameAccessorAstro:
    """Celestial transforms as virtual columns (vaex-astro's
    transformations.py DataFrameAccessorAstro)."""

    def __init__(self, df):
        self.df = df

    # -- frame rotations ---------------------------------------------------
    def celestial(self, long_in, lat_in, long_out, lat_out, matrix,
                  name_prefix="__celestial", radians=False, inplace=False):
        """Rotate (long, lat) through a 3x3 frame matrix: unit-sphere
        cartesian, matrix product, back to angles — each step a virtual
        column (vaex-astro's transformations.py:217-243)."""
        df = self.df if inplace else self.df.copy()
        m = FRAME_MATRICES[matrix] if isinstance(matrix, str) else matrix
        a, d = str(long_in), str(lat_in)
        if not radians:
            a, d = f"radians({a})", f"radians({d})"
        x_in = f"{name_prefix}_x_in"
        y_in = f"{name_prefix}_y_in"
        z_in = f"{name_prefix}_z_in"
        df.add_virtual_column(x_in, f"cos({a}) * cos({d})")
        df.add_virtual_column(y_in, f"sin({a}) * cos({d})")
        df.add_virtual_column(z_in, f"sin({d})")
        out_names = [f"{name_prefix}_x_out", f"{name_prefix}_y_out",
                     f"{name_prefix}_z_out"]
        for row, out in zip(m, out_names):
            terms = [f"({row[j]!r}) * {v}" for j, v in enumerate((x_in, y_in, z_in))]
            df.add_virtual_column(out, " + ".join(terms))
        xo, yo, zo = out_names
        back = "" if radians else " * 180.0 / pi"
        df.add_variable("pi", np.pi)
        df.add_virtual_column(long_out, f"arctan2({yo}, {xo}){back}")
        df.add_virtual_column(
            lat_out, f"(pi / 2 - arccos({zo} / sqrt({xo}**2 + {yo}**2 + {zo}**2))){back}")
        return df

    def eq2gal(self, long_in="ra", lat_in="dec", long_out="l", lat_out="b",
               name_prefix="__celestial_eq2gal", radians=False, inplace=False):
        """Equatorial -> galactic (vaex-astro's transformations.py:67-79)."""
        return self.celestial(long_in, lat_in, long_out, lat_out, "eq2gal",
                              name_prefix=name_prefix, radians=radians,
                              inplace=inplace)

    def gal2eq(self, long_in="l", lat_in="b", long_out="ra", lat_out="dec",
               name_prefix="__celestial_gal2eq", radians=False, inplace=False):
        """Galactic -> equatorial (vaex-astro's transformations.py:80-92)."""
        return self.celestial(long_in, lat_in, long_out, lat_out, "gal2eq",
                              name_prefix=name_prefix, radians=radians,
                              inplace=inplace)

    def eq2ecl(self, long_in="ra", lat_in="dec", long_out="lambda_",
               lat_out="beta", name_prefix="__celestial_eq2ecl", radians=False,
               inplace=False):
        """Equatorial -> ecliptic (vaex-astro's transformations.py:54-66)."""
        return self.celestial(long_in, lat_in, long_out, lat_out, "eq2ecl",
                              name_prefix=name_prefix, radians=radians,
                              inplace=inplace)

    # -- proper motions ----------------------------------------------------
    def pm_eq2gal(self, long_in="ra", lat_in="dec", pm_long="pm_ra",
                  pm_lat="pm_dec", pm_long_out="pm_l", pm_lat_out="pm_b",
                  name_prefix="__proper_motion_eq2gal",
                  right_ascension_galactic_pole=192.85,
                  declination_galactic_pole=27.12,
                  propagate_uncertainties=False, radians=False, inverse=False,
                  inplace=False):
        """Rotate proper motions equatorial -> galactic (the Poleski 2013
        rotation, arXiv:1306.2945; vaex-astro's transformations.py:93-141)."""
        df = self.df if inplace else self.df.copy()
        a, d = str(long_in), str(lat_in)
        if not radians:
            a, d = f"radians({a})", f"radians({d})"
        ap = math.radians(right_ascension_galactic_pole)
        dp = math.radians(declination_galactic_pole)
        c1 = f"{name_prefix}_C1"
        c2 = f"{name_prefix}_C2"
        df.add_virtual_column(
            c1, f"{math.sin(dp)!r} * cos({d}) - {math.cos(dp)!r} * sin({d}) * cos({a} - {ap!r})")
        df.add_virtual_column(c2, f"{math.cos(dp)!r} * sin({a} - {ap!r})")
        norm = f"sqrt({c1}**2 + {c2}**2)"
        pl, pb = str(pm_long), str(pm_lat)
        if inverse:
            df.add_virtual_column(pm_long_out, f"({c1} * {pl} - {c2} * {pb}) / {norm}")
            df.add_virtual_column(pm_lat_out, f"({c2} * {pl} + {c1} * {pb}) / {norm}")
        else:
            df.add_virtual_column(pm_long_out, f"({c1} * {pl} + {c2} * {pb}) / {norm}")
            df.add_virtual_column(pm_lat_out, f"(-{c2} * {pl} + {c1} * {pb}) / {norm}")
        if propagate_uncertainties:
            df.propagate_uncertainties([df[pm_long_out], df[pm_lat_out]])
        return df

    def pm_gal2eq(self, long_in="ra", lat_in="dec", pm_long="pm_l",
                  pm_lat="pm_b", pm_long_out="pm_ra", pm_lat_out="pm_dec",
                  name_prefix="__proper_motion_gal2eq",
                  right_ascension_galactic_pole=192.85,
                  declination_galactic_pole=27.12,
                  propagate_uncertainties=False, radians=False, inplace=False):
        """Inverse of :meth:`pm_eq2gal` (vaex-astro's transformations.py:143-157)."""
        return self.pm_eq2gal(long_in=long_in, lat_in=lat_in, pm_long=pm_long,
                              pm_lat=pm_lat, pm_long_out=pm_long_out,
                              pm_lat_out=pm_lat_out, name_prefix=name_prefix,
                              right_ascension_galactic_pole=right_ascension_galactic_pole,
                              declination_galactic_pole=declination_galactic_pole,
                              propagate_uncertainties=propagate_uncertainties,
                              radians=radians, inverse=True, inplace=inplace)

    def proper_motion2vperpendicular(self, distance="distance", pm_long="pm_l",
                                     pm_lat="pm_b", vl="vl", vb="vb",
                                     propagate_uncertainties=False,
                                     radians=False, inplace=False):
        """Tangential velocities [km/s] from proper motions [mas/yr] and
        distance [kpc] (vaex-astro's transformations.py:190-215)."""
        df = self.df if inplace else self.df.copy()
        df.add_variable("k_pm", K_PM, unique=False)
        df.add_virtual_column(vl, f"k_pm * ({pm_long}) * ({distance})")
        df.add_virtual_column(vb, f"k_pm * ({pm_lat}) * ({distance})")
        if propagate_uncertainties:
            df.propagate_uncertainties([df[vl], df[vb]])
        return df

    def cartesian_angular_momenta(self, x="x", y="y", z="z", vx="vx", vy="vy",
                                  vz="vz", Lx="Lx", Ly="Ly", Lz="Lz",
                                  propagate_uncertainties=False, inplace=False):
        """L = r x v per row (vaex-astro's transformations.py:159-188)."""
        df = self.df if inplace else self.df.copy()
        df.add_virtual_column(Lx, f"({y}) * ({vz}) - ({z}) * ({vy})")
        df.add_virtual_column(Ly, f"({z}) * ({vx}) - ({x}) * ({vz})")
        df.add_virtual_column(Lz, f"({x}) * ({vy}) - ({y}) * ({vx})")
        if propagate_uncertainties:
            df.propagate_uncertainties([df[Lx], df[Ly], df[Lz]])
        return df

    def parallax2distance(self, parallax="parallax", distance_name="distance",
                          parallax_uncertainty=None,
                          uncertainty_postfix="_uncertainty", inplace=False):
        """distance [kpc] = 1 / parallax [mas]
        (vaex-astro's transformations.py:323-347)."""
        df = self.df if inplace else self.df.copy()
        df.add_virtual_column(distance_name, f"1.0 / ({parallax})")
        if parallax_uncertainty:
            df.add_virtual_column(
                distance_name + uncertainty_postfix,
                f"({parallax_uncertainty}) / ({parallax})**2")
        return df
