"""The paper's baseline intermediate filters (host numpy): 5C+CH and RA."""
