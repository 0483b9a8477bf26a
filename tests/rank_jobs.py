"""Several jobs in one spawn of ranks (``multihost.run_ranks``).  A spawn
costs the ranks' start and imports, seconds each time, so a test module
that runs several jobs over the same ranks runs them in one.  This
module imports no JAX: the spawned ranks import it."""


def run_jobs(rank, jobs):
    """``[fn(rank, *args) for fn, args in jobs]`` on this rank, in order
    (every rank runs the same jobs, so their collectives pair up)."""
    return [fn(rank, *args) for fn, args in jobs]
