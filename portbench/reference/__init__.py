"""Plain references: the fitters and targets in plain torch, written from the
papers' updates.  Nothing here imports the program or takes anything it made:
the reference draws its own normals (the program's stream, by the frozen
``seeds.step_seed``) and works out its own precision matrix."""
