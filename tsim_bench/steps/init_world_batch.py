"""Set-up step: a batch of different cities, each from its own key of
`prng.split(PRNGKey(seed), n_worlds)`, every leaf with a leading world
dim (`parallel.mesh.init_world_batch`).  With a sample (the reference),
only those worlds, from the same keys, one world each (`sim.init_world`):
a list."""


def run(pkg, ctx, n_worlds: int):
    if ctx["sample"] is None:
        ctx["world"] = pkg.mesh.init_world_batch(
            ctx["cfg"], ctx["key"], n_worlds, device=ctx["device"])
    else:
        keys = pkg.prng.split(ctx["key"], n_worlds)[ctx["sample"]]
        ctx["world"] = [pkg.sim.init_world(ctx["cfg"], k, ctx["device"])
                        for k in keys]
