"""Operations and bytes counted from shapes, one module per configuration."""
