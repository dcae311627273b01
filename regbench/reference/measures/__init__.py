"""Distance measures of the plain reference, one module each, found by the
configuration's ``measure``."""
