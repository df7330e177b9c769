"""design_s (s, host design): host clock around the port's
``proceed_controller`` in set-up."""


def read(ctx):
    return ctx.get("design_s")
