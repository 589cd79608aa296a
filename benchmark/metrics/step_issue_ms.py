"""The mean host time a call spends before it returns, before the
synchronize: the serving step's own host work (host clock, traced run)."""


def read(ctx):
    return 1e3 * sum(ctx.issue_s) / len(ctx.issue_s)
