"""S3DIS reading, parsed superpoint rows, SPG entries, batch collation."""
