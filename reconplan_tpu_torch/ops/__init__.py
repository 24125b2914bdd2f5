"""Dense and brick TSDF fusion, table marching cubes, nearest neighbours,
and the CUDA kernels of the brick path (``ops.kernels``)."""
