"""The DSTformer backbone, its registry and weight conversion."""
