"""The bytes and operations of the step's functions, one file each."""
