"""index_build_s (index construction, host clock): ``ReadMapper.build``
in set-up, index and genome on the card."""


def read(ctx):
    return ctx.index_build_s
