"""Dense and brick TSDF fusion, raycasting, marching cubes (table and
tetra), nearest neighbours, and the CUDA kernels of the brick paths
(``ops.kernels``)."""
