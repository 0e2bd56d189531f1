"""Worker pool and job meshes of the port."""
