"""Frozen traffic generators: the inputs of every cell, made from the
seed. They are copies, so that a later change to the port's renderer,
arc or trajectory code cannot move the traffic the benchmark offers."""
