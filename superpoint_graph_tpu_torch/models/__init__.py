"""PointNet embedder, ECC graph network, recurrent cells, SpgModel."""
