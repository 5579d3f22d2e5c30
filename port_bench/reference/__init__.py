"""The plain reference the harness holds each answer of the program to."""
