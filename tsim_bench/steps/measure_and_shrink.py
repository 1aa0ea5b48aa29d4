"""Set-up step: the world's padded capacities measured and the Config
shrunk to them (`sim.measure_and_shrink`: MAX_FIELD_DESTS to the field
rows the city needs)."""


def run(pkg, ctx):
    ctx["cfg"], ctx["world"] = pkg.sim.measure_and_shrink(ctx["cfg"],
                                                          ctx["world"])
