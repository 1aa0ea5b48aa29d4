"""Set-up step: one city from PRNGKey(seed) (`sim.init_world`)."""


def run(pkg, ctx):
    ctx["world"] = pkg.sim.init_world(ctx["cfg"], ctx["key"], ctx["device"])
