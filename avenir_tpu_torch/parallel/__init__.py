"""Host → device staging of test rows."""
