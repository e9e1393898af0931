-- Copied from nds_tpu/data_maintenance/DF_SS.sql, unchanged.
-- DF_SS: delete store channel rows in the [DATE1, DATE2] sales-date window
-- (role of reference nds/data_maintenance/DF_SS.sql: returns first via the
-- ticket-number subquery, then the sales rows).
DELETE FROM store_returns WHERE sr_ticket_number IN
  (SELECT ss_ticket_number FROM store_sales WHERE ss_sold_date_sk IN
    (SELECT d_date_sk FROM date_dim
     WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE)));
DELETE FROM store_sales WHERE ss_sold_date_sk IN
  (SELECT d_date_sk FROM date_dim
   WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE))
