"""One JSON file of sizes and settings a configuration, and its plain
reference beside it (`<name>.py`), which names the scene's geometry:

  affine(x, cfg, eps, t)   the hard boundary conditions in the affine form
                           u = A raw + c: (A, c, drawn), `drawn` marking
                           points whose value the program draws at random
  fluid_mask(x, cfg)       (inside, band): the points of the fluid, and
                           those float32 and float64 may decide apart
  clamp_back(x, cfg)       a back-traced point brought into the domain
  wall_distance(x, cfg)    (unsigned distance to the boundary, outside)
  pressure(div, pts, cfg, dtype)
                           (p, grad p) at pts of the divergence grid's
                           pressure solve, before the walls' masks

A box scene takes the last four from reference/box.py."""
