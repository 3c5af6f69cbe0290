"""setup_s: process start to the first timed request (host clock): the
models made from the seed on the card, the traffic made, every shape it
uses warmed, and in a checkout's first run the kernels built."""


def read(run):
    return run.setup_s
