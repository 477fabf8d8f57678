"""Utilities: synthetic genomes and reads for tests and checks, option
files, host timers, leveled logging and alignment statistics."""
