"""Set-up step: n vehicles placed on reachable free road cells with
random destinations (`sim.inject_vehicles`, the JAX bench's synthetic
load)."""


def run(pkg, ctx, n: int):
    ctx["world"] = pkg.sim.inject_vehicles(ctx["cfg"], ctx["world"], n)
