"""One module a kind of timed call, named by a traffic file's ``entry`` key.

Each module holds ``Entry``, a subclass of :class:`port_bench.entry.Entry`:
it makes its inputs from the seed, sets up the program, makes one timed call,
works out again what that call had to produce (with the plain reference) and
says what the call's work is for the roofline.
"""
