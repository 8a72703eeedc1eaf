"""Green's functions, Bessel functions, direction sampling and the
walk's counter-based random numbers."""
