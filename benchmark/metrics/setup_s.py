"""Set-up seconds: process start to the first timed step."""


def read(ctx):
    return ctx.run.setup_s
