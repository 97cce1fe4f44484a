"""Small shared utilities: the sorted map and the failpoint registry."""
