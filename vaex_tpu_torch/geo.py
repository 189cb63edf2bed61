"""Coordinate transforms as virtual columns: ``df.geo`` (vaex_tpu/geo.py).

Spherical, cartesian and polar transforms, rotations, projections and
bearings are expression rewrites only: the functions they call
(``radians``, ``arctan2``, ``sqrt`` ...) are device functions of
:mod:`.functions`, so a pass evaluates them per tile on its device.
``inside_polygon`` is the device ``pnpoly`` over the polygon's vertices
kept as variables of the frame.
"""

from __future__ import annotations

import numpy as np

from .dataframe import register_dataframe_accessor


@register_dataframe_accessor("geo")
class DataFrameAccessorGeo:
    def __init__(self, df):
        self.df = df

    def spherical2cartesian(self, alpha, delta, distance, xname="x", yname="y", zname="z",
                            propagate_uncertainties=False, center=(0, 0, 0), radians=False):
        """(vaex's geo.py spherical2cartesian)"""
        df = self.df
        a, d, r = str(alpha), str(delta), str(distance)
        if not radians:
            a = f"radians({a})"
            d = f"radians({d})"
        df[xname] = f"cos({a}) * cos({d}) * ({r}) + {center[0]}"
        df[yname] = f"sin({a}) * cos({d}) * ({r}) + {center[1]}"
        df[zname] = f"sin({d}) * ({r}) + {center[2]}"
        if propagate_uncertainties:
            # first-order error propagation through the coordinate change
            # (vaex's geo.py:58-59)
            df.propagate_uncertainties([df[xname], df[yname], df[zname]])
        return df

    def cartesian2spherical(self, x="x", y="y", z="z", alpha="l", delta="b",
                            distance="distance", radians=False, center=None):
        df = self.df
        cx, cy, cz = center or (0, 0, 0)
        xs = f"({x} - {cx})" if cx else str(x)
        ys = f"({y} - {cy})" if cy else str(y)
        zs = f"({z} - {cz})" if cz else str(z)
        df[distance] = f"sqrt({xs}**2 + {ys}**2 + {zs}**2)"
        alpha_expr = f"arctan2({ys}, {xs})"
        delta_expr = f"arctan2({zs}, sqrt({xs}**2 + {ys}**2))"
        if not radians:
            alpha_expr = f"degrees({alpha_expr})"
            delta_expr = f"degrees({delta_expr})"
        df[alpha] = alpha_expr
        df[delta] = delta_expr
        return df

    def cartesian2polar(self, x="x", y="y", radius_out="polar_radius",
                        azimuth_out="polar_azimuth", radians=False,
                        propagate_uncertainties=False):
        df = self.df
        df[radius_out] = f"sqrt(({x})**2 + ({y})**2)"
        az = f"arctan2({y}, {x})"
        df[azimuth_out] = az if radians else f"degrees({az})"
        if propagate_uncertainties:
            df.propagate_uncertainties([df[radius_out], df[azimuth_out]])
        return df

    # vaex's name (geo.py:96); cartesian2polar is the short alias
    def cartesian_to_polar(self, *args, **kwargs):
        return self.cartesian2polar(*args, **kwargs)

    def rotation_2d(self, x, y, xnew, ynew, angle_degrees,
                    propagate_uncertainties=False):
        """Rotate (x, y) by a fixed angle (vaex's geo.py:257)."""
        df = self.df
        theta = float(angle_degrees) * np.pi / 180.0
        c, s = float(np.cos(theta)), float(np.sin(theta))
        df[xnew] = f"({x}) * {c!r} - ({y}) * {s!r}"
        df[ynew] = f"({x}) * {s!r} + ({y}) * {c!r}"
        if propagate_uncertainties:
            df.propagate_uncertainties([df[xnew], df[ynew]])
        return df

    def velocity_cartesian2polar(self, x="x", y="y", vx="vx", vy="vy",
                                 vr_out="vr_polar", vazimuth_out="vphi_polar",
                                 radius_polar=None,
                                 propagate_uncertainties=False):
        """(vaex's geo.py:158): vr = (x vx + y vy)/r, vphi the tangential
        component."""
        df = self.df
        if radius_polar is None:
            radius_polar = f"sqrt(({x})**2 + ({y})**2)"
        df[vr_out] = f"(({x}) * ({vx}) + ({y}) * ({vy})) / ({radius_polar})"
        df[vazimuth_out] = f"(({x}) * ({vy}) - ({y}) * ({vx})) / ({radius_polar})"
        if propagate_uncertainties:
            df.propagate_uncertainties([df[vr_out], df[vazimuth_out]])
        return df

    def velocity_cartesian2spherical(self, x="x", y="y", z="z", vx="vx",
                                     vy="vy", vz="vz", vr="vr", vlong="vlong",
                                     vlat="vlat", distance=None):
        """(vaex's geo.py:186): radial + two tangential velocity
        components in spherical coordinates."""
        df = self.df
        if distance is None:
            distance = f"sqrt(({x})**2 + ({y})**2 + ({z})**2)"
        df[vr] = (f"(({x}) * ({vx}) + ({y}) * ({vy}) + ({z}) * ({vz}))"
                  f" / ({distance})")
        df[vlong] = (f"-(({x}) * ({vy}) - ({y}) * ({vx}))"
                     f" / sqrt(({x})**2 + ({y})**2)")
        df[vlat] = (f"-(({z}) * (({x}) * ({vx}) + ({y}) * ({vy}))"
                    f" - (({x})**2 + ({y})**2) * ({vz}))"
                    f" / (({distance}) * sqrt(({x})**2 + ({y})**2))")
        return df

    def polar2cartesian(self, azimuth="polar_azimuth", radius="polar_radius",
                        x_out="x", y_out="y", radians=False):
        df = self.df
        az = str(azimuth) if radians else f"radians({azimuth})"
        df[x_out] = f"({radius}) * cos({az})"
        df[y_out] = f"({radius}) * sin({az})"
        return df

    def velocity_polar2cartesian(self, x="x", y="y", azimuth=None,
                                 velocity_radial="vr_radial", velocity_azimuthal="vphi",
                                 velocity_cartesian_x="vx", velocity_cartesian_y="vy",
                                 propagate_uncertainties=False):
        df = self.df
        if azimuth is None:
            azimuth = f"arctan2({y}, {x})"
        df[velocity_cartesian_x] = f"({velocity_radial}) * cos({azimuth}) - ({velocity_azimuthal}) * sin({azimuth})"
        df[velocity_cartesian_y] = f"({velocity_radial}) * sin({azimuth}) + ({velocity_azimuthal}) * cos({azimuth})"
        if propagate_uncertainties:
            df.propagate_uncertainties([df[velocity_cartesian_x],
                                        df[velocity_cartesian_y]])
        return df

    def bearing(self, lon1, lat1, lon2, lat2, bearing="bearing"):
        """Great-circle bearing (vaex's geo.py bearing)."""
        df = self.df
        l1, p1, l2, p2 = (f"radians({e})" for e in (lon1, lat1, lon2, lat2))
        df[bearing] = (f"degrees(arctan2(sin({l2} - {l1}) * cos({p2}), "
                       f"cos({p1}) * sin({p2}) - sin({p1}) * cos({p2}) * cos({l2} - {l1})))")
        return df

    def project_aitoff(self, alpha, delta, x="x_aitoff", y="y_aitoff", radians=True):
        """Aitoff projection (vaex's geo.py project_aitoff)."""
        df = self.df
        a, d = str(alpha), str(delta)
        if not radians:
            a = f"radians({a})"
            d = f"radians({d})"
        aitoff_z = f"sqrt((1 + cos({d}) * cos(({a}) / 2)) / 2)"
        df[x] = f"cos({d}) * sin(({a}) / 2) / ({aitoff_z})"
        df[y] = f"sin({d}) / ({aitoff_z})"
        return df

    def project_gnomic(self, alpha, delta, alpha0=0, delta0=0, x="x_gnomic", y="y_gnomic",
                       radians=False, postfix=""):
        df = self.df
        if not radians:
            alpha0 = np.radians(alpha0)
            delta0 = np.radians(delta0)
        a = f"radians({alpha})" if not radians else str(alpha)
        d = f"radians({delta})" if not radians else str(delta)
        c = (f"(sin({delta0}) * sin({d}) + cos({delta0}) * cos({d}) * "
             f"cos({a} - {alpha0}))")
        df[x + postfix] = f"degrees(cos({d}) * sin({a} - {alpha0}) / {c})"
        df[y + postfix] = (f"degrees((cos({delta0}) * sin({d}) - sin({delta0}) * cos({d}) * "
                           f"cos({a} - {alpha0})) / {c})")
        return df

    def inside_polygon(self, x, y, px, py):
        """Point-in-polygon expression (vaex's geo.py inside_polygon,
        vaexfast.pnpoly)."""
        df = self.df
        xs = df.add_variable("poly_x", np.asarray(px, np.float64), unique=True)
        ys = df.add_variable("poly_y", np.asarray(py, np.float64), unique=True)
        from .expression import Expression
        return Expression(df, f"pnpoly({x}, {y}, {xs}, {ys})")

    def inside_which_polygon(self, x, y, pxs, pys):
        """Index of the first polygon containing each point, else missing."""
        df = self.df
        exprs = [self.inside_polygon(x, y, px, py) for px, py in zip(pxs, pys)]
        # nested where(): first match wins
        result = "-1"
        for i in reversed(range(len(exprs))):
            result = f"where({exprs[i].expression}, {i}, {result})"
        from .expression import Expression
        return Expression(df, result)
