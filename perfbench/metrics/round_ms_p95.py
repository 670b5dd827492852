"""The 95th percentile of the host wall of every round of the window,
each ending in a device synchronisation, in ms (linear interpolation
between order statistics)."""
import numpy as np


def read(rec):
    walls = rec["round_walls_s"]
    if not walls:
        return None
    return float(np.percentile(np.asarray(walls) * 1e3, 95))
