"""The plain float32 reference and the lower-precision control."""
