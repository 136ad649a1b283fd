"""The smallest coordinate ESS a second: the sum over the window's runs
of each run's smallest ESS over the coordinates, over the sum of those
runs' walls, each from its dispatch to its synchronize (host clock)."""


def read(rec):
    ess, walls = rec.get("ess"), rec.get("walls_s")
    if not ess or not walls or sum(walls) <= 0:
        return None
    return sum(ess) / sum(walls)
