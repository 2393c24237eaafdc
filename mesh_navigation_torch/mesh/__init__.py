"""Mesh substrate: CSR tables, geometry, spatial queries, synthetic meshes."""
