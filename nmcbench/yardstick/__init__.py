"""The benchmark's frozen yardstick: the least work of a fit iteration,
the published peaks of one H100, and the reduction of a profiler trace.
Copies of the program's arithmetic, kept here so that a change to the
program cannot move the ruler it is measured with."""
